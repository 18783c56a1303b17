"""The LETKF in torch: a batched local ensemble transform Kalman filter.

Counterpart of ``efa_xray_tpu/assimilation/letkf_core.py``:
``_solve_precision_obj`` :57, ``PatchWeights`` :76, ``_top_k`` :88,
``select_local_obs`` :108, ``_sel_cost`` :143, ``host_select_candidates``
:156 (NumPy and SciPy, copied), ``_invsqrt_newton_schulz`` :340,
``_invsqrt_eigh`` :425, ``solve_patch_weights`` :444,
``apply_patch_weights`` :551, ``_analyze_body_chunked`` :592 and
``letkf_update`` :838.  The math (Hunt, Kostelich & Szunyogh 2007) is in
the docstring there: every observation is analysed at once, with an
independent ensemble-space solve per local patch of ``patch_size`` grid
points sharing the weights of their centroid, over the ``k_obs`` nearest
observations.  With localization off the analysis mean and covariance
are the serial EnSRF's (``unbiased=True``).

The JAX package runs all of it as XLA operations, with no Pallas kernel,
and so does the port as torch operations:

* ``lax.map`` over chunks of patches becomes a Python loop with the same
  ``chunk`` meaning: the ``[M, M]`` transforms live only per chunk, so
  memory stays O(state), never O(npatch M^2).  The last chunk is padded
  as the JAX package pads it (the padding takes part in the chunk's
  Newton-Schulz exit test, as there), and its padding is dropped.
* The chordal dots that rank the neighbours are three products and two
  sums in the inputs' dtype, rounded to float32 as the JAX package's
  ``preferred_element_type=float32`` rounds them: never a matrix product,
  so TF32 cannot reach them.  (TF32 on these K = 3 dots mis-ranks
  neighbours by hundreds of km.)
* :func:`_top_k` keeps ``jax.lax.top_k``'s order: descending, and on a
  tie the lower index first (``torch.topk`` alone does not promise it).
* A chunk's solve (:class:`_ChunkSolver`) on CUDA float32 tensors is two
  kernels: LG (:mod:`efa_xray_tpu_torch.ops.letkf_gram`: the weights
  ``rho / R``, ``A`` and ``b`` of every unit) and NS
  (:mod:`efa_xray_tpu_torch.ops.newton_schulz`: Newton-Schulz with
  ``jax.lax.while_loop``'s exit rule kept exactly, the exit test on the
  card, its end writing ``W`` and ``wbar``), so an update reads nothing
  back to the host.  On CPU tensors and in float64 LG's plain version
  runs, then the plain Newton-Schulz loop, which reads each iteration's
  error back, counted in :data:`host_syncs`.
* The sweep applies a chunk's weights with two batched products written
  into the posterior (horizontal mode: each patch's rows of every (var,
  time) group side by side, the JAX package's transpose).
* ``solve_precision`` is validated and runs true fp32 (or float64) for
  every setting, as the JAX package runs it off the TPU: the LETKF has no
  body kernel, and every product outside the body kernels stays fp32
  (:mod:`efa_xray_tpu_torch.ops.precision`).

Counters (reset with :func:`reset_counts`): :data:`ns_calls` Newton-Schulz
solves, :data:`ns_iterations` their iterations summed,
:data:`ns_max_iterations` the most one took, :data:`host_syncs` the device
values read back.  The kernel's iterations are tallied on its device and
folded into the two iteration counters when asked (:func:`ns_counts`),
never inside an update.

Spans (:mod:`efa_xray_tpu_torch.utils.profiling`, recorded only while a
``torch.profiler`` session records): ``efa.route.letkf`` around
:func:`letkf_update`, ``efa.ops.letkf_select`` around each chunk's
selection and the obs-space :func:`select_local_obs`, and
``efa.ops.letkf_solve`` around each chunk's solve (LG and NS issued); the
apply stays under the route's span.
"""

from __future__ import annotations

import math
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from efa_xray_tpu_torch.assimilation.ensrf_core import (
    ObsArrays,
    ObsDiagnostics,
    _empty_diags,
)
from efa_xray_tpu_torch.observation.localization import latlon_to_unit
from efa_xray_tpu_torch.utils import profiling

ns_calls = 0
ns_iterations = 0
ns_max_iterations = 0
host_syncs = 0
# The kernel's iterations per device, not yet folded into the counters:
# int64 [summed, most in one solve].
_device_tally: dict = {}
# Guards the counters against solves from several threads.
_count_lock = threading.Lock()


def reset_counts() -> None:
    global ns_calls, ns_iterations, ns_max_iterations, host_syncs
    with _count_lock:
        ns_calls = ns_iterations = ns_max_iterations = host_syncs = 0
        _device_tally.clear()


def ns_counts() -> dict:
    """The counters, the kernel's tallies folded into
    :data:`ns_iterations` and :data:`ns_max_iterations` first (one read
    per device: never call it inside an update)."""
    global ns_iterations, ns_max_iterations
    with _count_lock:
        tallies = list(_device_tally.values())
        _device_tally.clear()
    for t in tallies:
        total, most = (int(v) for v in t.cpu())
        with _count_lock:
            ns_iterations += total
            ns_max_iterations = max(ns_max_iterations, most)
    return dict(calls=ns_calls, iterations=ns_iterations,
                max_iterations=ns_max_iterations, host_syncs=host_syncs)


def _solve_precision_obj(solve_precision: str) -> Optional[str]:
    """Validate the ``solve_precision`` knob.  Every setting runs the
    ensemble-space solve in the working dtype's full precision (no TF32):
    the JAX package's ``"default"`` and ``"high"`` lower the TPU's matrix
    unit input; here only the body kernels' products take a lower mode
    (:mod:`efa_xray_tpu_torch.ops.precision`)."""
    if solve_precision in (None, "default", "high", "highest"):
        return solve_precision
    raise ValueError(f"unknown solve_precision {solve_precision!r}")


class PatchWeights(NamedTuple):
    """Per-patch ensemble-space analysis weights."""

    wbar: torch.Tensor  # [P, M]  mean-update weights
    transform: torch.Tensor  # [P, M, M] symmetric sqrt transform W


# ---------------------------------------------------------------------------
# Local observation selection
# ---------------------------------------------------------------------------


def _chord_dots(p: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """Chordal dots ``p . o`` of unit vectors, ``p [..., P, 3]`` against
    ``o [..., O, 3]`` -> float32 ``[..., P, O]``: three products and two
    sums in the inputs' dtype (no matrix product, so no TF32), rounded to
    float32 as the JAX package's ``preferred_element_type`` rounds them."""
    p = p.unsqueeze(-2)
    o = o.unsqueeze(-3)
    d = p[..., 0] * o[..., 0] + p[..., 1] * o[..., 1] + p[..., 2] * o[..., 2]
    return d.to(torch.float32)


def _top_k(dots: torch.Tensor, k: int, method: str = "exact") -> torch.Tensor:
    """Indices of the ``k`` largest float32 ``dots`` along the last axis,
    in ``jax.lax.top_k``'s order: descending, ties to the lower index,
    and ``-0.0`` below ``+0.0`` (its total order on the bits).

    The order is made exact by ranking int64 keys: the float's bits mapped
    to a monotone integer in the high half, the reversed index in the low
    half.  ``method="approx"`` (the JAX package's ``approx_max_k``, exact
    off the TPU) runs the same exact selection."""
    if method not in ("exact", "approx"):
        raise ValueError(f"unknown top-k method {method!r}")
    bits = dots.contiguous().view(torch.int32)
    key = (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64) << 32
    n = dots.shape[-1]
    rev = (n - 1) - torch.arange(n, dtype=torch.int64, device=dots.device)
    return torch.topk(key | rev, k, dim=-1).indices


@profiling.spanned(profiling.OPS_LETKF_SELECT)
def select_local_obs(patch_xyz, obs_xyz, k: int, chunk: int = 4096,
                     topk_method: str = "exact") -> torch.Tensor:
    """Indices of the k nearest observations per patch, ``[P, k]``:
    nearest by great-circle distance == largest chordal dot, ranked in
    chunks of patches to bound the ``[chunk, No]`` score buffer."""
    npatch = patch_xyz.shape[0]
    k = int(min(k, obs_xyz.shape[0]))
    out = [
        _top_k(_chord_dots(patch_xyz[s:s + chunk], obs_xyz), k, topk_method)
        for s in range(0, npatch, chunk)
    ]
    if not out:
        return torch.zeros((0, k), dtype=torch.int64, device=obs_xyz.device)
    return torch.cat(out)


def _sel_cost(s: int, group: int) -> float:
    """Cost model for one (candidate width S, bundle size) choice, the
    JAX package's: per-patch rescoring work is ~ S, and per-group work
    (the candidates' gather and broadcast) ~ S/group per patch, so
    shrinking the bundle shrinks S but multiplies the shared-row overhead:
    cost = S (1 + 16/g)."""
    return s * (1.0 + 16.0 / group)


def host_select_candidates(grid_lat, grid_lon, ngrid: int, patch_size: int,
                           obs_lat, obs_lon, k: int, chunk: int = 512,
                           group: int = 64, slack: float = 1e-5,
                           auto_group: bool = True):
    """Certified per-GROUP candidate obs sets for EXACT nearest-k
    selection (``letkf_topk="host"``), copied from the JAX package.

    Bundle ``group`` adjacent patches, and compute ONE candidate set per
    bundle that provably contains every member patch's true nearest-k; the
    device then ranks its exact chordal dots over the ``S << No``
    candidates only.

    Certificate (chord metric; exact, not heuristic): let ``c`` be the
    bundle centroid, ``d = max_p |p - c|`` over member patch centers, and
    ``r_k(c)`` the k-th-nearest-ob distance from ``c``.  The k-th-NN
    distance is 1-Lipschitz in the query point, so for any member patch
    ``p`` and any ob ``o`` in ``p``'s true top-k:
    ``|c - o| <= |p - o| + d <= r_k(p) + d <= r_k(c) + 2d``.
    Hence ``ball(c, r_k(c) + 2d)`` covers every member's top-k; ``slack``
    absorbs the f32 device patch centers vs these f64 host centers.
    Candidate lists are sorted by obs index so tie-breaking matches the
    device-exact path's stable top-k.

    Mirrors :func:`_analyze_body_chunked`'s horizontal-mode padding
    exactly (patch -> chunk -> group alignment).  Returns
    ``(cand [Gn, S] int32, mask [Gn, S] bool, group_eff)`` with
    ``Gn = padded_units / group_eff`` and ``group_eff = gcd(group,
    effective chunk)`` so groups tile device chunks.
    """
    from scipy.spatial import cKDTree

    glat = np.asarray(grid_lat, np.float64)[:ngrid]
    glon = np.asarray(grid_lon, np.float64)[:ngrid]
    olat = np.asarray(obs_lat, np.float64)
    olon = np.asarray(obs_lon, np.float64)
    nobs = olat.shape[0]
    kk = int(min(k, nobs))

    def unit(lat, lon):
        la, lo = np.radians(lat), np.radians(lon)
        cl = np.cos(la)
        return np.stack([cl * np.cos(lo), cl * np.sin(lo), np.sin(la)], -1)

    npatch = -(-ngrid // patch_size)
    gpad = npatch * patch_size - ngrid
    gx = unit(glat, glon)
    if gpad:
        gx = np.concatenate([gx, np.repeat(gx[-1:], gpad, axis=0)], axis=0)
    px = gx.reshape(npatch, patch_size, 3).mean(axis=1)
    px /= np.maximum(np.linalg.norm(px, axis=-1, keepdims=True), 1e-12)

    chunkc = int(min(chunk, npatch))
    nchunks = -(-npatch // chunkc)
    padded = nchunks * chunkc
    oxyz = unit(olat, olon)
    tree = cKDTree(oxyz)

    def certify(group_try: int):
        """Bundle certificates for one bundle size: member patch centers
        ``pxg``, bundle ``centers``, certified ball ``radius`` and the
        ``wide`` mask (space-curve-jump bundles whose centroid ball would
        blow up — certified per member patch instead; see below)."""
        ngroups_real = -(-npatch // group_try)
        ppad = ngroups_real * group_try - npatch
        pxg = px
        if ppad:
            pxg = np.concatenate(
                [pxg, np.repeat(pxg[-1:], ppad, axis=0)], axis=0)
        pxg = pxg.reshape(ngroups_real, group_try, 3)
        centers = pxg.mean(axis=1)
        centers /= np.maximum(
            np.linalg.norm(centers, axis=-1, keepdims=True), 1e-12)
        d = np.linalg.norm(pxg - centers[:, None, :], axis=-1).max(axis=1)
        rk = tree.query(centers, k=kk, workers=-1)[0]
        rk = rk[:, -1] if kk > 1 else np.reshape(rk, (-1,))
        radius = rk + 2.0 * d + slack
        # Wide groups (space-curve jumps: members far from the centroid)
        # make the centroid certificate's ball huge, and ONE such group
        # would blow the global candidate width S toward No.  For those,
        # certify per member patch instead (d = 0 by construction:
        # ball(p, r_k(p) + slack) contains p's top-k by definition) and
        # take the union — a few clusters' worth of candidates, not the
        # sphere.
        wide = radius > np.minimum(2.0, rk + 2.0 * np.median(d) + 0.1)
        return pxg, centers, radius, wide

    def member_radii(members):
        rkp = tree.query(members, k=kk, workers=-1)[0]
        return (rkp[:, -1] if kk > 1 else np.reshape(rkp, (-1,))) + slack

    def est_width(group_try: int):
        """Exact candidate width S for one bundle size WITHOUT materializing
        the big tight-bundle lists: COUNT-only kd queries
        (``return_length=True``) give the tight widths, and the few wide
        (space-curve-jump) bundles — whose union a count sum would badly
        overestimate and distort the cost ranking — materialize their
        member lists (dozens of bundles, not thousands).  Returns
        ``(s, cert, wide_lists)`` so the winner's :func:`build` reuses the
        certificate and the wide-bundle unions."""
        cert = certify(group_try)
        pxg, centers, radius, wide = cert
        tight = np.nonzero(~wide)[0]
        s = kk
        wide_lists = {}
        if tight.size:
            counts = tree.query_ball_point(
                centers[tight], radius[tight], workers=-1,
                return_length=True)
            s = max(s, int(np.max(counts)))
        for g in np.nonzero(wide)[0]:
            acc: set = set()
            for lst in tree.query_ball_point(pxg[g], member_radii(pxg[g])):
                acc.update(lst)
            wide_lists[int(g)] = sorted(acc)
            s = max(s, len(acc))
        return s, cert, wide_lists

    def build(cert, wide_lists):
        """Candidate lists from a certificate; returns (lists, s_max).
        Tight bundles materialize here (only the WINNING bundle size pays
        this); wide-bundle unions come precomputed from est_width."""
        pxg, centers, radius, wide = cert
        lists = [None] * len(centers)
        tight = np.nonzero(~wide)[0]
        for g, lst in zip(tight, tree.query_ball_point(
                centers[tight], radius[tight], workers=-1)):
            lists[g] = lst
        for g in np.nonzero(wide)[0]:
            lists[g] = wide_lists[int(g)]
        return lists, max(kk, max(len(lst) for lst in lists))

    # Auto group size: the device rescoring cost is ~ proportional to the
    # candidate width S, and S grows with the bundle radius's 2d term —
    # which shrinks with smaller bundles (at the cost of more, cheaper,
    # host queries).  Rank group, group/4, group/16 by the COUNT-only
    # width estimate and materialize lists ONLY for the winner.
    g0 = math.gcd(int(group), chunkc)
    cands_g = ((g0, *(g for g in (g0 // 4, g0 // 16)
                      if g >= 1 and g0 % g == 0))
               if auto_group else (g0,))
    tried = []
    certs = {}
    for g_try in cands_g:
        s_t, cert, wide_lists = est_width(g_try)
        certs[g_try] = (cert, wide_lists)
        tried.append((_sel_cost(s_t, g_try), g_try))
        if s_t <= 2 * kk:  # already near the k floor; stop refining
            break
    _, group_eff = min(tried, key=lambda t: (t[0], -t[1]))
    lists, s_max = build(*certs[group_eff])
    ngroups_real = -(-npatch // group_eff)
    s_cap = int(min(-(-s_max // 8) * 8, nobs))
    ngroups_total = padded // group_eff
    cand = np.zeros((ngroups_total, s_cap), np.int32)
    mask = np.zeros((ngroups_total, s_cap), np.bool_)
    for g, lst in enumerate(lists):
        idx = np.sort(np.asarray(lst, np.int64))[:s_cap]
        cand[g, : idx.size] = idx
        mask[g, : idx.size] = True
    for g in range(ngroups_real, ngroups_total):  # device upad region
        cand[g] = cand[ngroups_real - 1]
        mask[g] = mask[ngroups_real - 1]
    return cand, mask, group_eff


# ---------------------------------------------------------------------------
# Batched SPD inverse / inverse-sqrt
# ---------------------------------------------------------------------------


def _read(x: torch.Tensor) -> float:
    """A device scalar on the host, counted in :data:`host_syncs`."""
    global host_syncs
    with _count_lock:
        host_syncs += 1
    return float(x)


def _invsqrt_newton_schulz(a: torch.Tensor, iters: int):
    """Batched ``(A^{-1/2}, A^{-1})`` for SPD ``A [..., M, M]`` by
    :func:`_invsqrt_newton_schulz_plain` (the update's solve goes through
    :func:`_newton_schulz_weights`, which launches NS on the card)."""
    return _invsqrt_newton_schulz_plain(a, iters)[:2]


def _tally(device) -> torch.Tensor:
    """One more kernel solve on ``device``: its int64 ``[summed, most]``
    tally of iterations, which the kernel adds to on the card."""
    global ns_calls
    with _count_lock:
        ns_calls += 1
        t = _device_tally.get(device)
        if t is None:
            t = _device_tally[device] = torch.zeros(2, dtype=torch.int64,
                                                    device=device)
        return t


def _invsqrt_newton_schulz_plain(a: torch.Tensor, iters: int):
    """Batched ``(A^{-1/2}, A^{-1})`` for SPD ``A [..., M, M]`` by coupled
    Newton-Schulz (Denman-Beavers variant): scale ``A`` by an upper
    spectral bound c (max abs row sum), then iterate
    ``T = (3 I - Z Y) / 2;  Y <- Y T;  Z <- T Z``, which drives
    ``Z -> (A/c)^{-1/2}``.

    ``iters`` is the cap; the loop exits as soon as the whole batch has
    converged, by the JAX package's rule: ``max |ZY - I|`` at most 100 eps
    of the dtype, or below 0.1 and not halved by the last iteration (a
    stall at the precision floor).  Each iteration reads that error back
    to the host (one sync).  Returns ``(A^{-1/2}, A^{-1}, iterations)``."""
    from efa_xray_tpu_torch.ops.newton_schulz import (
        _finish,
        _scaled,
        exit_thresholds,
    )

    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    c, y, z = _scaled(a)
    tol, quad = exit_thresholds(a.dtype)
    i = 0
    err = prev = math.inf
    while i < iters and err > tol and not (err < quad and err > 0.5 * prev):
        zy = z @ y
        new_err = torch.amax(torch.abs(zy - eye))
        t = 1.5 * eye - 0.5 * zy
        y = y @ t
        z = t @ z
        i += 1
        prev, err = err, (_read(new_err) if i < iters else err)
    _count_ns(i)
    return (*_finish(z, c), i)


def _count_ns(iterations: int) -> None:
    """One Newton-Schulz call of ``iterations`` iterations."""
    global ns_calls, ns_iterations, ns_max_iterations
    with _count_lock:
        ns_calls += 1
        ns_iterations += iterations
        ns_max_iterations = max(ns_max_iterations, iterations)


def _invsqrt_eigh(a: torch.Tensor):
    """Reference backend: batched eigendecomposition."""
    e, v = torch.linalg.eigh(a)
    e = torch.clamp(e, min=1e-30)
    vt = v.transpose(-1, -2)
    inv_sqrt = (v * (1.0 / torch.sqrt(e))[..., None, :]) @ vt
    inv = (v * (1.0 / e)[..., None, :]) @ vt
    return inv_sqrt, inv


# ---------------------------------------------------------------------------
# Per-patch ensemble-space solve
# ---------------------------------------------------------------------------


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x`` with ``n`` zero rows appended (the JAX package's ``jnp.pad``
    of a chunk's solve inputs)."""
    if n == 0:
        return x
    return torch.cat([x, x.new_zeros((n,) + tuple(x.shape[1:]))])


class _ChunkSolver:
    """One update's ensemble-space analysis, chunk by chunk (Hunt et al.
    2007, eqs. 20-23): for each unit over its local obs ``ii``, ``A = (M-1)
    I + Y^T diag(a) Y``, ``wbar = A^{-1} Y^T diag(a) d``, ``W = sqrt(M-1)
    A^{-1/2}``, ``a = rho / R``.

    On CUDA float32 tensors a chunk is one LG launch (``a``, ``A`` and
    ``b``; the obs packed once per update) and, with Newton-Schulz, one NS
    launch, whose end writes ``W`` and ``wbar``; with ``reuse`` their
    outputs live in buffers that every chunk of the update writes again
    (each chunk's weights are applied before the next chunk's launches, in
    stream order).  Elsewhere the plain versions run: LG's, then the plain
    Newton-Schulz loop (or eigh) and the two products."""

    def __init__(self, ye, innov, rinv, obs_xyz, obs_radii, *, localize,
                 sqrt_method: str, ns_iters: int, obs_verts=None,
                 obs_vert_radii=None, varloc=None, obs_var=None,
                 reuse: bool = False):
        from efa_xray_tpu_torch.ops import letkf_gram

        self.ye, self.innov, self.rinv = ye, innov, rinv
        self.obs_xyz, self.obs_radii = obs_xyz, obs_radii
        self.obs_verts, self.obs_vert_radii = obs_verts, obs_vert_radii
        self.localize, self.sqrt_method = localize, sqrt_method
        self.ns_iters = ns_iters
        self.vlm_t = self.ovar = None
        if varloc is not None:
            self.vlm_t = varloc.to(ye.dtype).T.contiguous()
            self.ovar = obs_var.long()
        self.kernel = ye.is_cuda and ye.dtype == torch.float32
        self.table = None
        if self.kernel:
            self.table = letkf_gram.obs_table(obs_xyz, obs_radii, rinv, innov,
                                              obs_verts, obs_vert_radii)
        self.bufs = {} if reuse else None

    def _buf(self, name, shape):
        """A reused output buffer of the kernels (None without ``reuse``
        and off the kernel route)."""
        if self.bufs is None or not self.kernel:
            return None
        t = self.bufs.get(name)
        if t is None or tuple(t.shape) != tuple(shape):
            t = self.bufs[name] = torch.empty(shape, dtype=self.ye.dtype,
                                              device=self.ye.device)
        return t

    @profiling.spanned(profiling.OPS_LETKF_SOLVE)
    def __call__(self, px, ii, pv=None, uv=None):
        """``(wbar [C, M], W [C, M, M])`` of the chunk's units: centroids
        ``px [C, 3]``, local obs ``ii [C, K]``, levels ``pv [C]`` (vertical
        factor) and variables ``uv [C]`` (varloc)."""
        from efa_xray_tpu_torch.ops import letkf_gram

        c, m = ii.shape[0], self.ye.shape[1]
        amat, b = letkf_gram.local_gram(
            self.ye, self.innov, self.rinv, self.obs_xyz, self.obs_radii, px,
            ii, localize=self.localize, pv=pv, obs_verts=self.obs_verts,
            obs_vert_radii=self.obs_vert_radii, vlm_t=self.vlm_t, uv=uv,
            obs_var=self.ovar, table=self.table,
            amat=self._buf("amat", (c, m, m)), b=self._buf("b", (c, m)))
        if self.sqrt_method == "eigh":
            inv_sqrt, inv = _invsqrt_eigh(amat)
            return (inv @ b[..., None])[..., 0], math.sqrt(m - 1) * inv_sqrt
        return _newton_schulz_weights(
            amat, b, self.ns_iters, w_out=self._buf("w", (c, m, m)),
            wbar_out=self._buf("wbar", (c, m)), ws=self.bufs)


def _newton_schulz_weights(amat, b, iters: int, w_out=None, wbar_out=None,
                           ws=None):
    """``(wbar = A^{-1} b, W = sqrt(M-1) A^{-1/2})`` by Newton-Schulz: on
    CUDA float32 one NS launch (its iterations tallied on the device; ``W``
    into ``w_out`` and ``wbar`` into ``wbar_out`` where given, its work
    buffers kept in the dict ``ws``), else
    :func:`_invsqrt_newton_schulz_plain` and the two products."""
    m = amat.shape[-1]
    if not (amat.is_cuda and amat.dtype == torch.float32):
        inv_sqrt, inv = _invsqrt_newton_schulz_plain(amat, iters)[:2]
        return (inv @ b[..., None])[..., 0], math.sqrt(m - 1) * inv_sqrt
    from efa_xray_tpu_torch.ops import newton_schulz

    scale = np.sqrt(np.float32(m - 1))
    w, wbar, _ = newton_schulz.solve(
        amat, iters, b=b, scale=scale, out=w_out,
        wbar_out=(torch.empty_like(b) if wbar_out is None else wbar_out),
        tally=_tally(amat.device), ws=ws)
    return wbar, w


def solve_patch_weights(ye, innov, rinv, obs_xyz, obs_radii, patch_xyz, idx,
                        *, localize: bool = True,
                        sqrt_method: str = "newton_schulz",
                        ns_iters: int = 30, chunk: int = 512,
                        patch_verts=None, obs_verts=None, obs_vert_radii=None,
                        solve_precision: str = "default", varloc=None,
                        obs_var=None, patch_var=None) -> PatchWeights:
    """The LETKF ensemble-space analysis of every patch ``[P]`` over its
    local obs ``idx [P, K]``, in chunks of ``chunk`` patches.  ``W 1 = 1``
    exactly (perturbations stay centred) because ``Y 1 = 0`` makes ``1``
    an eigenvector of ``A`` with eigenvalue ``M - 1``."""
    _solve_precision_obj(solve_precision)
    npatch = idx.shape[0]
    chunk = int(min(chunk, npatch))
    nchunks = -(-npatch // chunk)
    pad = nchunks * chunk - npatch
    idx = _pad_rows(idx, pad)
    pxyz = _pad_rows(patch_xyz, pad)
    pvert = None if patch_verts is None else _pad_rows(
        patch_verts.to(ye.dtype), pad)
    use_vl = varloc is not None
    pvar = _pad_rows(patch_var.long(), pad) if use_vl else None
    solver = _ChunkSolver(ye, innov, rinv, obs_xyz, obs_radii,
                          localize=localize, sqrt_method=sqrt_method,
                          ns_iters=ns_iters, obs_verts=obs_verts,
                          obs_vert_radii=obs_vert_radii, varloc=varloc,
                          obs_var=obs_var)
    wbars, ws = [], []
    for s in range(0, nchunks * chunk, chunk):
        sl = slice(s, s + chunk)
        wbar, w = solver(pxyz[sl], idx[sl],
                         pv=None if pvert is None else pvert[sl],
                         uv=pvar[sl] if use_vl else None)
        wbars.append(wbar)
        ws.append(w)
    return PatchWeights(wbar=torch.cat(wbars)[:npatch],
                        transform=torch.cat(ws)[:npatch])


# ---------------------------------------------------------------------------
# Patch geometry + weight application
# ---------------------------------------------------------------------------


def apply_patch_weights(body_mean, body_perts, weights: PatchWeights,
                        ngrid: int, patch_size: int):
    """Transform the state body by per-patch weights: one batched product.
    Rows are ``(var, time, grid)`` C-order; all VT = nvars*ntimes copies
    of a grid point share its patch weights (exact for horizontal
    localization)."""
    nrows, nens = body_perts.shape
    vt = nrows // ngrid
    npatch = weights.wbar.shape[0]
    pad = npatch * patch_size - ngrid
    dtype = body_perts.dtype
    xm = body_mean.reshape(vt, ngrid)
    xp = body_perts.reshape(vt, ngrid, nens)
    if pad:
        xm = torch.nn.functional.pad(xm, (0, pad))
        xp = torch.nn.functional.pad(xp, (0, 0, 0, pad))
    xm = xm.reshape(vt, npatch, patch_size)
    xp = xp.reshape(vt, npatch, patch_size, nens)
    post_mean = xm + torch.einsum("vpsm,pm->vps", xp,
                                  weights.wbar.to(dtype))
    post_perts = torch.einsum("vpsm,pmk->vpsk", xp,
                              weights.transform.to(dtype))
    post_mean = post_mean.reshape(vt, npatch * patch_size)[:, :ngrid]
    post_perts = post_perts.reshape(vt, npatch * patch_size, nens)[:, :ngrid]
    return post_mean.reshape(nrows), post_perts.reshape(nrows, nens)


# ---------------------------------------------------------------------------
# Fused select -> solve -> apply sweep (the production body path)
# ---------------------------------------------------------------------------


@profiling.spanned(profiling.OPS_LETKF_SELECT)
def _select_chunk(px, obs_xyz, k: int, topk_method: str, cand=None,
                  mask=None, group: int = 0) -> torch.Tensor:
    """The ``k`` nearest obs of each patch centroid ``px [C, 3]``: over
    all obs, or (``topk_method="host"``) over the certified candidates
    ``cand [G, S]`` (``mask`` their validity) of each group of ``group``
    patches.  Returns ``[C, k]`` obs indices."""
    if topk_method != "host":
        return _top_k(_chord_dots(px, obs_xyz), k, topk_method)
    ngroups, nsc = cand.shape
    dg = _chord_dots(px.reshape(ngroups, group, 3), obs_xyz[cand])
    dg = dg.masked_fill(~mask[:, None, :], -math.inf)
    pos = _top_k(dg, k)  # [G, P, K]
    ii = torch.gather(cand[:, None, :].expand(ngroups, group, nsc), 2, pos)
    return ii.reshape(ngroups * group, k)


def _apply_chunk(xm_c, xp_c, wbar, w, pm_c, pp_c) -> None:
    """One chunk's posterior, written into ``pm_c`` and ``pp_c``: ``xm +
    Xp wbar`` and ``Xp W`` on the rows ``[C, R(, M)]`` of each unit (its
    patch's ``R = S`` rows in vertical mode, its ``R = VT S`` rows in every
    group otherwise), two batched products."""
    torch.baddbmm(xm_c, xp_c, wbar[:, :, None], out=pm_c)
    torch.bmm(xp_c, w, out=pp_c)


def _analyze_body_chunked(body_mean, body_perts, ye, innov, rinv, obs_xyz,
                          obs_radii, grid_xyz, *, ngrid: int,
                          patch_size: int, k_obs: int, sqrt_method: str,
                          ns_iters: int, chunk: int, group_vert=None,
                          obs_verts=None, obs_vert_radii=None,
                          topk_method: str = "exact",
                          solve_precision: str = "default", sel_cand=None,
                          sel_mask=None, sel_group: int = 0, varloc=None,
                          obs_var=None, group_var=None):
    """Localized LETKF body analysis, a loop over chunks of analysis
    units: each chunk selects its local obs, solves and applies, so the
    ``[M, M]`` transforms live only per chunk.

    Horizontal-only mode (``group_vert=None``): one unit per spatial patch,
    shared by all VT = nvars*ntimes copies of its rows (exact).  Vertical
    mode: rho gains a vertical Gaspari-Cohn factor per level, so one unit
    per (group, patch), VT times the solves (and the mode ``varloc``
    needs: a variable-dependent rho, ``group_var`` the variable of each
    group)."""
    _solve_precision_obj(solve_precision)
    nens = body_perts.shape[1]
    dtype = body_perts.dtype
    nrows = body_mean.shape[0]
    vt = nrows // ngrid
    k = int(min(k_obs, ye.shape[0]))
    vertical = group_vert is not None
    npatch = -(-ngrid // patch_size)
    gpad = npatch * patch_size - ngrid

    xm = body_mean.reshape(vt, ngrid)
    xp = body_perts.reshape(vt, ngrid, nens)
    gx = grid_xyz
    if gpad:
        xm = torch.nn.functional.pad(xm, (0, gpad))
        xp = torch.nn.functional.pad(xp, (0, 0, 0, gpad))
        gx = torch.cat([gx, gx[-1:].expand(gpad, 3)])
    pxyz = gx.reshape(npatch, patch_size, 3).mean(dim=1)
    pxyz = pxyz / torch.clamp(torch.linalg.norm(pxyz, dim=-1, keepdim=True),
                              min=1e-12)

    use_vl = varloc is not None
    if use_vl and not vertical:
        raise ValueError(
            "varloc needs the per-(group, patch) unit layout; callers set "
            "vertical=True with zero group verticals when only variable "
            "localization is active (letkf_update does this)")
    if vertical:
        nunits = vt * npatch
        xm = xm.reshape(nunits, patch_size, 1)
        xp = xp.reshape(nunits, patch_size, nens)
        pxyz = pxyz.repeat(vt, 1)
        pvert = group_vert.to(dtype).repeat_interleave(npatch)
        uvar = (group_var.long().repeat_interleave(npatch) if use_vl
                else None)
    else:
        # One unit per patch: its rows in every (var, time) group side by
        # side, [P, VT * S(, M)] (the JAX package's transpose; a copy only
        # where VT > 1).
        nunits = npatch
        xm = xm.reshape(vt, npatch, patch_size).transpose(0, 1).reshape(
            npatch, vt * patch_size, 1)
        xp = xp.reshape(vt, npatch, patch_size, nens).transpose(0, 1).reshape(
            npatch, vt * patch_size, nens)
        pvert = uvar = None

    chunk = int(min(chunk, nunits))
    nchunks = -(-nunits // chunk)
    upad = nchunks * chunk - nunits
    # The solve inputs of the last chunk are padded as the JAX package
    # pads them (zero centroids, level 0, variable 0); the state is not.
    pxyz = _pad_rows(pxyz, upad)
    if vertical:
        pvert = _pad_rows(pvert, upad)
        if use_vl:
            uvar = _pad_rows(uvar, upad)

    host_sel = topk_method == "host"
    if host_sel:
        if vertical:
            raise ValueError(
                "letkf_topk='host' supports horizontal-only localization; "
                "use 'exact' or 'approx' with vertical localization")
        if sel_cand is None or sel_mask is None or sel_group <= 0:
            raise ValueError(
                "letkf_topk='host' needs sel_cand/sel_mask/sel_group from "
                "host_select_candidates")
        if chunk % sel_group:
            raise ValueError(
                f"sel_group {sel_group} must divide the effective chunk "
                f"{chunk} (host_select_candidates guarantees this when "
                f"given the same chunk/patch geometry)")
        gpc = chunk // sel_group
        if sel_cand.shape[0] != nchunks * gpc:
            raise ValueError(
                f"sel_cand has {sel_cand.shape[0]} groups, geometry needs "
                f"{nchunks * gpc} (stale candidates for this grid/chunk?)")
        if sel_cand.shape[-1] < k:
            raise ValueError(f"candidate width {sel_cand.shape[-1]} < k {k}")
        sel_cand = sel_cand.long()

    solver = _ChunkSolver(ye, innov, rinv, obs_xyz, obs_radii, localize=True,
                          sqrt_method=sqrt_method, ns_iters=ns_iters,
                          obs_verts=obs_verts, obs_vert_radii=obs_vert_radii,
                          varloc=varloc, obs_var=obs_var, reuse=True)
    pm = torch.empty_like(xm)
    pp = torch.empty_like(xp)
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        px = pxyz[sl]
        if host_sel:
            gsl = slice(c * gpc, (c + 1) * gpc)
            ii = _select_chunk(px, obs_xyz, k, "host", sel_cand[gsl],
                               sel_mask[gsl], sel_group)
        else:
            ii = _select_chunk(px, obs_xyz, k, topk_method)
        wbar, w = solver(px, ii, pv=pvert[sl] if vertical else None,
                         uv=uvar[sl] if use_vl else None)
        real = min(chunk, nunits - c * chunk)
        usl = slice(c * chunk, c * chunk + real)
        _apply_chunk(xm[usl], xp[usl], wbar[:real], w[:real], pm[usl],
                     pp[usl])
    if not vertical:
        pm = pm.reshape(npatch, vt, patch_size).transpose(0, 1)
        pp = pp.reshape(npatch, vt, patch_size, nens).transpose(0, 1)
    pm = pm.reshape(vt, npatch * patch_size)[:, :ngrid]
    pp = pp.reshape(vt, npatch * patch_size, nens)[:, :ngrid]
    return pm.reshape(nrows), pp.reshape(nrows, nens)


# ---------------------------------------------------------------------------
# Full update
# ---------------------------------------------------------------------------


@profiling.spanned(profiling.ROUTE_LETKF)
def letkf_update(body_mean, body_perts, tail_mean, tail_perts, grid_lat,
                 grid_lon, obs: ObsArrays, *, ngrid: int,
                 patch_size: int = 1, k_obs: int = 64, localize: bool = True,
                 sqrt_method: str = "newton_schulz", ns_iters: int = 30,
                 chunk: int = 512, vertical: bool = False, body_vert=None,
                 topk_method: str = "exact", unbiased: bool = False,
                 solve_precision: str = "default", sel_cand=None,
                 sel_mask=None, sel_group: int = 0, varloc=None, ob_var=None,
                 group_var=None):
    """One simultaneous LETKF analysis of all observations.

    ``grid_lat``/``grid_lon`` hold ONE copy of the spatial grid ``[G]``;
    ``body_vert [Ns]`` must put each (var, time) group at one level.
    ``varloc [nv(+1), nvars]`` multiplies rho per (analysed variable,
    observed variable) and forces per-(group, patch) solves; it needs
    ``ob_var`` and ``group_var [VT]``.  ``topk_method="host"`` takes the
    certified candidates ``sel_cand``/``sel_mask``/``sel_group`` of
    :func:`host_select_candidates`.

    Returns ``(body_mean, body_perts, tail_mean, tail_perts, diags)``, the
    contract of ``ensrf_core.ensrf_serial``.  With ``localize=False`` every
    patch sees every observation with weight one: the global ETKF, whose
    analysis mean and covariance match the serial EnSRF with
    ``unbiased=True``.
    """
    nens = body_perts.shape[1]
    dtype = body_perts.dtype
    device = body_perts.device
    nobs = obs.values.shape[0]
    if nobs == 0:
        return (body_mean, body_perts, tail_mean, tail_perts,
                _empty_diags(dtype, device))

    innov = (obs.values.to(dtype) - tail_mean).to(dtype)
    # R clamped away from zero, as in the JAX package (:895-899): direct
    # callers could otherwise feed rinv = inf into the solve.
    r_floor = torch.finfo(dtype).tiny
    rinv = torch.where(obs.assim,
                       1.0 / torch.clamp(obs.errors.to(dtype), min=r_floor),
                       torch.zeros((), dtype=dtype, device=device))
    obs_xyz = latlon_to_unit(obs.lats, obs.lons).to(dtype)
    radii = obs.radii.to(dtype)
    vertical = bool(vertical and localize and body_vert is not None)
    overts = ovrad = group_vert = None
    if vertical:
        obs = obs.with_default_verts()
        overts = obs.verts.to(dtype)
        ovrad = obs.vert_radii.to(dtype)
        vt = body_mean.shape[0] // ngrid
        group_vert = body_vert.reshape(vt, ngrid)[:, 0].to(dtype)

    use_vl = varloc is not None
    if use_vl:
        if not localize:
            raise ValueError(
                "varloc needs localization (the unlocalized global ETKF "
                "is one shared solve — a variable-dependent rho cannot "
                "apply)")
        if topk_method == "host":
            raise ValueError(
                "letkf_topk='host' does not combine with varloc (the "
                "per-(group, patch) unit layout); use 'exact' or 'approx'")
        if ob_var is None or group_var is None:
            raise ValueError("varloc needs ob_var and group_var")
        if not vertical:
            # Variable-dependent rho needs per-group solves: the vertical
            # unit layout with zero verticals (vertical radii default to
            # inf, so the vertical factor is exactly 1).
            vertical = True
            obs = obs.with_default_verts()
            overts = obs.verts.to(dtype)
            ovrad = obs.vert_radii.to(dtype)
            vt = body_mean.shape[0] // ngrid
            group_vert = torch.zeros(vt, dtype=dtype, device=device)

    def solve(pxyz, idx, **kw):
        return solve_patch_weights(
            tail_perts, innov, rinv, obs_xyz, radii, pxyz, idx,
            localize=localize, sqrt_method=sqrt_method, ns_iters=ns_iters,
            chunk=chunk, obs_verts=overts, obs_vert_radii=ovrad,
            solve_precision=solve_precision, varloc=varloc, obs_var=ob_var,
            **kw)

    if localize:
        grid_xyz = latlon_to_unit(grid_lat.to(dtype),
                                  grid_lon.to(dtype)).to(dtype)
        bm, bp = _analyze_body_chunked(
            body_mean, body_perts, tail_perts, innov, rinv, obs_xyz, radii,
            grid_xyz, ngrid=ngrid, patch_size=patch_size, k_obs=k_obs,
            sqrt_method=sqrt_method, ns_iters=ns_iters, chunk=chunk,
            group_vert=group_vert, obs_verts=overts, obs_vert_radii=ovrad,
            topk_method=topk_method, solve_precision=solve_precision,
            sel_cand=sel_cand, sel_mask=sel_mask, sel_group=sel_group,
            varloc=varloc, obs_var=ob_var, group_var=group_var)
        # Observation-space posterior: each ob's location is its own
        # patch, so H(x^a) transforms with local weights evaluated exactly
        # at the ob.
        ob_idx = select_local_obs(obs_xyz, obs_xyz, k_obs)
        ob_weights = solve(obs_xyz, ob_idx,
                           patch_verts=overts if vertical else None,
                           patch_var=ob_var if use_vl else None)
    else:
        # Global ETKF: one patch covering the whole grid, all obs, rho = 1.
        pxyz = torch.eye(3, dtype=dtype, device=device)[2:]
        idx = torch.arange(nobs, device=device)[None, :]
        weights = solve(pxyz, idx)
        bm, bp = apply_patch_weights(body_mean, body_perts, weights,
                                     ngrid=ngrid, patch_size=ngrid)
        ob_weights = PatchWeights(
            wbar=weights.wbar.expand(nobs, nens),
            transform=weights.transform.expand(nobs, nens, nens))
    tm = tail_mean + torch.sum(tail_perts * ob_weights.wbar, dim=1)
    tp = (tail_perts[:, None, :] @ ob_weights.transform)[:, 0, :]

    # Diagnostic variances follow the EnSRF's ddof convention
    # (``unbiased``), so adaptive-inflation statistics compare across
    # solvers; the ensemble-space solve itself is ddof=1.
    var_denom = (nens - 1) if unbiased else nens
    prior_var = torch.sum(tail_perts ** 2, dim=1) / var_denom
    post_var = torch.sum(tp ** 2, dim=1) / var_denom
    nan = torch.full((), float("nan"), dtype=dtype, device=device)
    diags = ObsDiagnostics(
        prior_mean=tail_mean, prior_var=prior_var,
        post_mean=torch.where(obs.assim, tm, nan),
        post_var=torch.where(obs.assim, post_var, nan),
        assimilated=obs.assim)
    return bm, bp, tm, tp, diags
