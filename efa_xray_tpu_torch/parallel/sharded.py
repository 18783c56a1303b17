"""Multi-device EnSRF, EnKF and LETKF: state body split, obs tail replicated.

Counterpart of ``efa_xray_tpu/parallel/sharded.py``:
``ensrf_update_sharded`` :207 (its ``_ensrf_sharded_impl`` :52 and
per-shard ``local_update`` :111), ``enkf_update_sharded`` :446 (:367)
and ``letkf_update_sharded`` :677 (:547).

Every quantity that couples state rows (``ye``, the per-ob gain and
square-root coefficients, the diagnostics) lives in the observation-space
tail, so the update is row-local: the JAX package runs it under
``shard_map`` with the body sharded along the state axis, the tail and
every per-ob array replicated, and no collective.  Here a
:class:`~efa_xray_tpu_torch.parallel.mesh.Mesh` is a list of devices
driven from one process, and each driver

1. pads the rows (the LETKF: the grid) to a multiple of the mesh size and
   copies each device its slice, and each distinct device the tail and
   the per-ob arrays (:func:`_to` makes every copy between devices);
2. solves the tail once, on the mesh's first device, and copies the
   solution to the other distinct devices, where the JAX package solves
   it redundantly (and bit-identically) on every device: the same
   function, paid once;
3. updates each shard on its own device (:func:`_ensrf_local`,
   :func:`_enkf_local`, :func:`_letkf_local`), touching no other shard,
   the shards issued in mesh order from the calling thread
   (:func:`run_shards`) with no synchronize between them, so that the
   cards run them at once, as ``shard_map`` runs its shards, wherever
   the host does not wait on a card (the kernel routes never do);
4. gathers the shards onto the input's device and drops the padding.

No copy between devices happens between the first shard's solve and the
last one's.

The EnSRF shard takes the route the JAX sharded path takes, through
:class:`~efa_xray_tpu_torch.assimilation.ensrf.FlatRoute` (a shard is a
flat slice of rows, so never B3): with ``fast_geometry`` or without
localization the body is B2 (B2h in hybrid mode), with
``spatial_sort`` within the shard; other blocked runs take B4;
``variable_localization``, hybrid at exact haversine and float64 on the
card take the plain blocked body; ``method="serial"``
runs ``ensrf_serial`` on each shard.  The kernel tail is B1 (B1h in hybrid
mode) with its out-of-panel apply.  The EnKF shard takes the
single-device EnKF's route (B1e tail once, then B2e or B4e per shard);
the LETKF's shard runs ``letkf_core.letkf_update``, its Newton-Schulz
the kernel NS on the card.  None of these routes reads a value back to
the host between the first shard's issue and the last one's.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional

import torch

from efa_xray_tpu_torch.assimilation import ensrf_core as core
from efa_xray_tpu_torch.assimilation.ensrf_core import ObsArrays
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.parallel.mesh import (
    STATE_AXIS,
    Mesh,
    pad_rows,
    pad_to_multiple,
)


def _to(x, device):
    """``x`` on ``device``: a tensor, or a tuple of them (a
    ``TailSolution``, the EnKF's ``(tail, z)``), None staying None.  Every
    copy between devices that the drivers make goes through here, before
    the first shard's solve or after the last one's."""
    if x is None:
        return None
    if isinstance(x, tuple):
        items = [_to(v, device) for v in x]
        return x._make(items) if hasattr(x, "_make") else tuple(items)
    return x.to(device)


def _obs_to(obs: ObsArrays, device) -> ObsArrays:
    return ObsArrays(*(_to(x, device) for x in obs.with_default_verts()))


def _split(x, mesh: Mesh, local: int, dim: int = 0):
    """Slice ``s`` of ``local`` entries along ``dim`` on ``mesh.devices[s]``,
    for every shard (None for None)."""
    if x is None:
        return [None] * mesh.size
    return [_to(x.narrow(dim, s * local, local), d)
            for s, d in enumerate(mesh.devices)]


def _gather(parts, device, dim: int = 0) -> torch.Tensor:
    return torch.cat([_to(p, device) for p in parts], dim=dim)


def run_shards(mesh: Mesh, work: Callable[[int], object]) -> List[object]:
    """``work(s)`` for every shard, issued in mesh order from the calling
    thread with no synchronize between shards, each with its own card
    current (an operation on tensors of another card than the current
    one switches devices around its launch)."""
    out = []
    for s, d in enumerate(mesh.devices):
        with (torch.cuda.device(d) if d.type == "cuda"
              else contextlib.nullcontext()):
            out.append(work(s))
    return out


# ---------------------------------------------------------------------------
# Sharded EnSRF
# ---------------------------------------------------------------------------


def _ensrf_local(solver, route: str, tail, bm, bp, blat, blon, bvert, obs,
                 tm, tp, vertical: bool, hkw: dict, vl: dict):
    """One shard's update on its own device (JAX ``local_update``):
    ``ensrf_serial`` on the serial route, else the body along ``route``
    on its device's pre-solved ``tail``; ``(bm, bp, tm, tp, diags)``."""
    if route == "serial":
        return solver.solve(bm, bp, tm, tp, blat, blon, obs, body_vert=bvert,
                            vertical=vertical, hkw=hkw, vl=vl)
    bm, bp = solver._body_apply(route, bm, bp, blat, blon, tail, obs, bvert,
                                vertical, hkw, vl)
    return bm, bp, tail.tail_mean, tail.tail_perts, tail.diags


def ensrf_update_sharded(body_mean, body_perts, tail_mean, tail_perts,
                         body_lat, body_lon, obs: ObsArrays, mesh: Mesh,
                         localize: bool = True, method: str = "blocked",
                         block_size: int = 32, axis_name: str = STATE_AXIS,
                         unbiased: bool = False,
                         fast_geometry: bool = False, body_vert=None,
                         vertical: bool = False, donate: bool = False,
                         tail_panel: int = 512, cull: bool = True,
                         spatial_sort: bool = False,
                         hybrid_alpha: float = 1.0, body_sigma=None,
                         tail_sigma=None, static_length=None, varloc=None,
                         row_var=None, ob_var=None,
                         max_radius_km: Optional[float] = None,
                         matmul_precision: Optional[str] = None,
                         mxu_bf16: bool = False):
    """Sharded EnSRF update: pad the state rows to a multiple of the mesh
    size (pad rows carry zero perturbations and coordinates (0, 0), so
    their updates are no-ops that never touch real rows), split them over
    the mesh, solve the tail once on the mesh's first device and copy it
    to the others, update the shards along their route
    (:func:`run_shards`), gather onto ``body_mean``'s device and unpad.
    ``(bm, bp, tm, tp, diags)``, the single-device update's function.

    Each shard takes :class:`FlatRoute`'s route (B1 + B2, B2h or B4 on
    CUDA float32 tensors, their plain versions on CPU tensors), where the
    JAX package selects its Pallas route with ``use_pallas``; with
    ``varloc`` the plain blocked body, which the JAX package takes there
    too.  ``body_sigma`` (hybrid) and ``row_var`` (varloc) are
    split with the rows; ``tail_sigma``, ``varloc`` and ``ob_var`` are
    replicated.  ``max_radius_km`` bounds the finite radii for B2's angle
    form.  ``matmul_precision`` and ``mxu_bf16`` give every shard's body
    kernel its product mode, as the single-device route does (JAX
    ``sharded.py:83``, :152, :235, :354).  ``donate=True`` lets the body
    kernels update the caller's ``body_mean``/``body_perts`` in place where
    a shard's slice is not copied (the JAX package donates them); the
    default leaves them untouched."""
    from efa_xray_tpu_torch.assimilation.ensrf import FlatRoute

    ns = int(body_mean.shape[0])
    ndev = mesh.shape[axis_name]
    ns_pad = pad_to_multiple(ns, ndev)
    local = ns_pad // ndev
    hybrid = hybrid_alpha < 1.0
    use_varloc = varloc is not None
    if hybrid and (body_sigma is None or tail_sigma is None
                   or static_length is None):
        raise ValueError("hybrid_alpha < 1 needs body_sigma, tail_sigma and "
                         "static_length")
    if use_varloc and (row_var is None or ob_var is None):
        raise ValueError("varloc needs row_var and ob_var")
    cfg = FilterConfig(
        localization="GC" if localize else None, method=method,
        block_size=block_size, unbiased_variance=unbiased,
        fast_geometry=fast_geometry, tail_panel=tail_panel, cull=cull,
        spatial_sort=spatial_sort,
        dtype=str(body_perts.dtype).removeprefix("torch."),
        hybrid_alpha=float(hybrid_alpha),
        static_b_sigma=body_sigma if hybrid else None,
        static_b_length=static_length if hybrid else None,
        matmul_precision=matmul_precision, mxu_bf16=mxu_bf16)

    bm = pad_rows(body_mean, ns_pad)
    bp = pad_rows(body_perts, ns_pad)
    if not donate and ns_pad == ns:
        bm, bp = bm.clone(), bp.clone()
    bsig = (pad_rows(core.sigma_rows(body_sigma, body_mean), ns_pad)
            if hybrid else None)
    shards = list(zip(
        _split(bm, mesh, local), _split(bp, mesh, local),
        _split(pad_rows(body_lat, ns_pad), mesh, local),
        _split(pad_rows(body_lon, ns_pad), mesh, local),
        _split(None if body_vert is None else pad_rows(body_vert, ns_pad),
               mesh, local),
        _split(bsig, mesh, local),
        _split(pad_rows(row_var, ns_pad) if use_varloc else None, mesh,
               local)))
    tsig = core.sigma_rows(tail_sigma, tail_mean) if hybrid else None
    rep = {d: dict(tm=_to(tail_mean, d), tp=_to(tail_perts, d),
                   obs=_obs_to(obs, d), tsig=_to(tsig, d),
                   varloc=_to(varloc, d), ob_var=_to(ob_var, d))
           for d in mesh.distinct_devices()}

    def hkw(r, bsig_s):
        return (dict(hybrid_alpha=float(hybrid_alpha), body_sigma=bsig_s,
                     tail_sigma=r["tsig"], static_length=float(static_length))
                if hybrid else {})

    def vl(r, rvar_s):
        return (dict(varloc=r["varloc"], row_var=rvar_s, ob_var=r["ob_var"])
                if use_varloc else {})

    solvers, routes = {}, {}
    for d in rep:
        solvers[d] = FlatRoute(cfg, d, max_radius_km)
        route = solvers[d]._route(local)
        if route != "serial" and use_varloc:
            route = "plain"  # no kernel carries varloc on a flat state
        routes[d] = route
    # The tail, once on the first device (JAX: on every device), copied
    # to the others before any shard's solve.
    d0, tails = mesh.devices[0], {}
    if routes[d0] != "serial":
        r = rep[d0]
        tail = solvers[d0]._kernel_tail(r["tm"], r["tp"], r["obs"], vertical,
                                        hkw(r, None), vl(r, None))
        tails = {d: _to(tail, d) for d in rep}

    def shard(s):
        d = mesh.devices[s]
        bm_s, bp_s, blat_s, blon_s, bvert_s, bsig_s, rvar_s = shards[s]
        r = rep[d]
        return _ensrf_local(
            solvers[d], routes[d], tails.get(d), bm_s, bp_s, blat_s, blon_s,
            bvert_s, r["obs"], r["tm"], r["tp"], vertical, hkw(r, bsig_s),
            vl(r, rvar_s))

    outs = run_shards(mesh, shard)
    home = body_mean.device
    bm = _gather([o[0] for o in outs], home)[:ns]
    bp = _gather([o[1] for o in outs], home)[:ns]
    _, _, tm, tp, diags = outs[0]
    return bm, bp, tm, tp, diags


# ---------------------------------------------------------------------------
# Sharded stochastic EnKF
# ---------------------------------------------------------------------------


def _enkf_local(route: str, tail, bm, bp, blat, blon, bvert, obs, eps,
                tm, tp, kw: dict, vl: dict, block_size: int, cull: bool):
    """One shard's stochastic EnKF on its own device, along ``route``
    (``enkf.enkf_route``): the serial per-ob loop, the plain blocked body,
    or B2e / B4e, each against the apply rows of its device's pre-solved
    tail; ``(bm, bp, tm, tp, diags)``."""
    from efa_xray_tpu_torch.assimilation import enkf

    if route == "serial":
        return enkf.enkf_serial(bm, bp, tm, tp, blat, blon, obs, eps, **kw,
                                **vl)
    body = dict(localize=kw["localize"], block_size=block_size,
                fast_geometry=kw["fast_geometry"], body_vert=kw["body_vert"],
                vertical=kw["vertical"], **vl)
    if route == "plain":
        bm, bp = core.ensrf_blocked_body(bm, bp, blat, blon, tail, obs,
                                         **body)
    else:
        bm, bp = enkf.enkf_kernel_body(route, bm, bp, blat, blon, tail, obs,
                                       cull=cull, **body)
    return bm, bp, tail.tail_mean, tail.tail_perts, tail.diags


def enkf_update_sharded(body_mean, body_perts, tail_mean, tail_perts,
                        body_lat, body_lon, obs: ObsArrays, eps, mesh: Mesh,
                        localize: bool = True, axis_name: str = STATE_AXIS,
                        unbiased: bool = False, fast_geometry: bool = False,
                        body_vert=None, vertical: bool = False,
                        method: str = "blocked", block_size: int = 128,
                        tail_panel: int = 512, cull: bool = True,
                        varloc=None, row_var=None, ob_var=None):
    """Sharded stochastic EnKF, with the layout of
    :func:`ensrf_update_sharded`: the body split over the mesh, the tail
    AND the perturbation table ``eps`` replicated (so the draws do not
    depend on the mesh), the tail solved once on the mesh's first device
    and copied to the others, each shard's rows swept along the
    single-device route (``enkf.enkf_route``): B1e + B2e or B4e on
    float32 (their plain versions on CPU tensors), the plain per-ob tail
    and blocked body with float64 on the card, the serial per-ob loop for
    ``method="serial"``."""
    from efa_xray_tpu_torch.assimilation import enkf

    ns = int(body_mean.shape[0])
    ndev = mesh.shape[axis_name]
    ns_pad = pad_to_multiple(ns, ndev)
    local = ns_pad // ndev
    use_varloc = varloc is not None
    if use_varloc and (row_var is None or ob_var is None):
        raise ValueError("varloc needs row_var and ob_var")
    shards = list(zip(
        _split(pad_rows(body_mean, ns_pad), mesh, local),
        _split(pad_rows(body_perts, ns_pad), mesh, local),
        _split(pad_rows(body_lat, ns_pad), mesh, local),
        _split(pad_rows(body_lon, ns_pad), mesh, local),
        _split(None if body_vert is None else pad_rows(body_vert, ns_pad),
               mesh, local),
        _split(pad_rows(row_var, ns_pad) if use_varloc else None, mesh,
               local)))
    rep = {d: dict(tm=_to(tail_mean, d), tp=_to(tail_perts, d),
                   obs=_obs_to(obs, d), eps=_to(eps, d),
                   varloc=_to(varloc, d), ob_var=_to(ob_var, d))
           for d in mesh.distinct_devices()}
    d0 = mesh.devices[0]
    route = enkf.enkf_route(method, localize, fast_geometry, use_varloc, d0,
                            body_perts.dtype)
    tails = {}
    if route != "serial":
        r = rep[d0]
        tkw = dict(localize=localize, unbiased=unbiased,
                   fast_geometry=fast_geometry, vertical=vertical,
                   **({"varloc": r["varloc"], "ob_var": r["ob_var"]}
                      if use_varloc else {}))
        if route == "plain":
            tail = enkf.enkf_tail_scan(r["tm"], r["tp"], r["obs"], r["eps"],
                                       **tkw)[0]
        else:
            tail = core.tail_scan_blocked(r["tm"], r["tp"], r["obs"],
                                          panel=tail_panel, kernels=True,
                                          eps=r["eps"], **tkw)
        tails = {d: _to(tail, d) for d in rep}

    def shard(s):
        d = mesh.devices[s]
        bm_s, bp_s, blat_s, blon_s, bvert_s, rvar_s = shards[s]
        r = rep[d]
        kw = dict(localize=localize, unbiased=unbiased,
                  fast_geometry=fast_geometry, body_vert=bvert_s,
                  vertical=vertical)
        vl = (dict(varloc=r["varloc"], row_var=rvar_s, ob_var=r["ob_var"])
              if use_varloc else {})
        return _enkf_local(route, tails.get(d), bm_s, bp_s, blat_s, blon_s,
                           bvert_s, r["obs"], r["eps"], r["tm"], r["tp"], kw,
                           vl, block_size, cull)

    outs = run_shards(mesh, shard)
    home = body_mean.device
    bm = _gather([o[0] for o in outs], home)[:ns]
    bp = _gather([o[1] for o in outs], home)[:ns]
    _, _, tm, tp, diags = outs[0]
    return bm, bp, tm, tp, diags


# ---------------------------------------------------------------------------
# Sharded LETKF
# ---------------------------------------------------------------------------


def _letkf_local(bm, bp, tm, tp, glat, glon, obs, bvert, cand, mask, *,
                 vt: int, g_local: int, chunk: int, patch_size: int,
                 vertical: bool, **kw):
    """One shard's LETKF on its own device: its ``g_local`` grid points of
    every (var, time) group, patch by patch (JAX ``local_update``);
    ``(bm [VT, g], bp [VT, g, M], tm, tp, diags)``."""
    from efa_xray_tpu_torch.assimilation import letkf_core

    nens = bp.shape[-1]
    bm2, bp2, tm2, tp2, diags = letkf_core.letkf_update(
        bm.reshape(vt * g_local), bp.reshape(vt * g_local, nens), tm, tp,
        glat, glon, obs, ngrid=g_local, patch_size=patch_size,
        chunk=min(chunk, max(1, -(-g_local // patch_size))),
        vertical=vertical,
        body_vert=bvert.reshape(vt * g_local) if vertical else None,
        sel_cand=cand, sel_mask=mask, **kw)
    return (bm2.reshape(vt, g_local), bp2.reshape(vt, g_local, nens), tm2,
            tp2, diags)


def letkf_update_sharded(body_mean, body_perts, tail_mean, tail_perts,
                         grid_lat, grid_lon, obs: ObsArrays, mesh: Mesh,
                         ngrid: int, patch_size: int = 1, k_obs: int = 64,
                         localize: bool = True,
                         sqrt_method: str = "newton_schulz",
                         ns_iters: int = 30, chunk: int = 512,
                         axis_name: str = STATE_AXIS, vertical: bool = False,
                         body_vert=None, unbiased: bool = False,
                         topk_method: str = "exact",
                         solve_precision: str = "default", sel_cand=None,
                         sel_mask=None, sel_group: int = 0, varloc=None,
                         ob_var=None, group_var=None):
    """Sharded LETKF: the GRID axis (not the flat rows) is split over the
    mesh, since the rows of a column share their patch's weights.  The
    grid is padded to a multiple of ``ndev * patch_size`` so that local
    patch boundaries equal the unsharded ones (pad points repeat the last
    grid point and are dropped afterwards): sharded and single-device
    analyses are identical.  Patches are independent and the tail, the
    obs and ``varloc``/``ob_var``/``group_var`` are replicated.
    ``topk_method="host"`` takes ``sel_cand``/``sel_mask`` in the sharded
    layout (``letkf._host_selection_cached(..., ndev=...)``: each shard's
    groups in turn), split with the grid."""
    ns = int(body_mean.shape[0])
    nens = body_perts.shape[1]
    vt = ns // ngrid
    ndev = mesh.shape[axis_name]
    g_pad = pad_to_multiple(ngrid, ndev * patch_size)
    pad = g_pad - ngrid
    g_local = g_pad // ndev

    bm = body_mean.reshape(vt, ngrid)
    bp = body_perts.reshape(vt, ngrid, nens)
    bvert = None if body_vert is None else body_vert.reshape(vt, ngrid)
    glat, glon = grid_lat, grid_lon
    if pad:
        bm = torch.nn.functional.pad(bm, (0, pad))
        bp = torch.nn.functional.pad(bp, (0, 0, 0, pad))
        glat = torch.cat([glat, glat[-1:].expand(pad)])
        glon = torch.cat([glon, glon[-1:].expand(pad)])
        if bvert is not None:
            bvert = torch.cat([bvert, bvert[:, -1:].expand(vt, pad)], dim=1)
    host_sel = topk_method == "host" and sel_cand is not None
    ngroups = int(sel_cand.shape[0]) // ndev if host_sel else 0
    shards = list(zip(
        _split(bm, mesh, g_local, dim=1), _split(bp, mesh, g_local, dim=1),
        _split(glat, mesh, g_local), _split(glon, mesh, g_local),
        _split(bvert, mesh, g_local, dim=1),
        _split(sel_cand if host_sel else None, mesh, ngroups),
        _split(sel_mask if host_sel else None, mesh, ngroups)))
    use_varloc = varloc is not None
    rep = {d: dict(tm=_to(tail_mean, d), tp=_to(tail_perts, d),
                   obs=_obs_to(obs, d), varloc=_to(varloc, d),
                   ob_var=_to(ob_var, d), group_var=_to(group_var, d))
           for d in mesh.distinct_devices()}

    def shard(s):
        bm_s, bp_s, glat_s, glon_s, bvert_s, cand_s, mask_s = shards[s]
        r = rep[mesh.devices[s]]
        return _letkf_local(
            bm_s, bp_s, r["tm"], r["tp"], glat_s, glon_s, r["obs"], bvert_s,
            cand_s, mask_s, vt=vt, g_local=g_local, chunk=chunk,
            patch_size=patch_size, vertical=vertical, k_obs=k_obs,
            localize=localize, sqrt_method=sqrt_method, ns_iters=ns_iters,
            unbiased=unbiased, topk_method=topk_method,
            solve_precision=solve_precision, sel_group=sel_group,
            **({k: r[k] for k in ("varloc", "ob_var", "group_var")}
               if use_varloc else {}))

    outs = run_shards(mesh, shard)
    home = body_mean.device
    bm = _gather([o[0] for o in outs], home, dim=1)[:, :ngrid].reshape(ns)
    bp = _gather([o[1] for o in outs], home, dim=1)[:, :ngrid].reshape(
        ns, nens)
    _, _, tm, tp, diags = outs[0]
    return bm, bp, tm, tp, diags
