"""LG: the LETKF chunk's local precision, ensemble-space Gram and right-hand
side in one kernel.

Counterpart of the rho and A / b einsums of each chunk in
``efa_xray_tpu/assimilation/letkf_core.py`` (``_analyze_body_chunked``
:592 and ``solve_patch_weights`` :444, their ``one``), plain XLA inside a
``lax.map`` there: no Pallas kernel.  For each unit ``c`` of a chunk over
its selected obs ``ii[c]``::

    a_k = rinv * GC(chord(px_c, obs_k), r_k) [* GC_v(|pv_c - v_k|, vr_k)]
          [* varloc[obs_var_k, unit_var_c]]
    A_c = (M - 1) I + sum_k a_k y_k y_k^T,   b_c = sum_k a_k d_k y_k

:func:`local_gram_cuda` launches the CUDA kernel of
``efa_xray_tpu_torch/csrc/letkf_gram.cu`` on CUDA float32 tensors (one
launch a chunk); :func:`local_gram_plain` is the same function in torch
(:func:`local_precision_plain`, the weights, then the two products), which
runs on CPU tensors and in float64, and against which ``chip_smoke.py``
holds the kernel.  :func:`local_gram` picks between them by the tensors'
device and dtype.  Any ensemble runs: past 256 members the kernel deals
each unit's ``A`` in blocks of 128 x 128 over CTAs of their own, with the
same sums in the same order.  The per-update inputs of the kernel (the
obs table) are packed once by :func:`obs_table`.
"""

from __future__ import annotations

import threading

import torch

from efa_xray_tpu_torch.observation.localization import (
    chordal_gc_weights,
    gaspari_cohn,
)
from efa_xray_tpu_torch.ops import _build

# Launches of the CUDA kernel (one a chunk), not of the plain version, and
# the lock that guards the count.
LAUNCHES_PER_CHUNK = 1
launches = 0
_count_lock = threading.Lock()

# Past this many members a unit's A is dealt in BLOCK x BLOCK blocks over
# CTAs of their own (csrc/letkf_gram.cu kSmallMembers, kBlk); a slice of
# SLICE obs at a time.
SMALL_MEMBERS = 256
BLOCK = 128
SLICE = 32


def smem_bytes(m: int) -> int:
    """Shared memory of one LG CTA at ``m`` members (mirrors
    ``csrc/letkf_gram.cu``): a slice's rows of Y twice, ``m`` rounded up
    to 4 wide, or one block's wide past ``SMALL_MEMBERS``."""
    width = -(-m // 4) * 4 if m <= SMALL_MEMBERS else BLOCK
    return 2 * SLICE * width * 4


def local_precision_plain(rinv, obs_xyz, obs_radii, px, ii, localize: bool,
                          pv=None, obs_verts=None, obs_vert_radii=None,
                          vlm_t=None, uv=None, obs_var=None):
    """``rho / R`` of each unit's local obs ``[C, K]``: chordal
    Gaspari-Cohn at the unit's centroid, times the vertical factor when
    ``pv`` is given, times the cross-variable factor
    ``varloc[obs_var[ob], unit_var]`` when ``vlm_t`` (``varloc.T``) is."""
    a = rinv[ii]
    if localize:
        rho = chordal_gc_weights(px[:, None, :], obs_xyz[ii],
                                 obs_radii[ii]).to(a.dtype)
        if pv is not None:
            rho = rho * gaspari_cohn(torch.abs(pv[:, None] - obs_verts[ii]),
                                     obs_vert_radii[ii]).to(a.dtype)
        a = a * rho
    if vlm_t is not None:
        a = a * torch.gather(vlm_t[uv], 1, obs_var[ii])
    return a


def gram_plain(ye, innov, a, ii):
    """``(A [C, M, M], b [C, M])`` from the weights ``a [C, K]``: ``A =
    (M - 1) I + (a y)^T y`` and ``b = (a y)^T d`` over the gathered rows
    ``y = ye[ii]``, ``d = innov[ii]``."""
    nens = ye.shape[1]
    yl = ye[ii]
    ya = yl * a[..., None]
    amat = (nens - 1) * torch.eye(nens, dtype=ye.dtype, device=ye.device) \
        + ya.transpose(1, 2) @ yl
    b = (ya.transpose(1, 2) @ innov[ii][..., None])[..., 0]
    return amat, b


def local_gram_plain(ye, innov, rinv, obs_xyz, obs_radii, px, ii, *,
                     localize: bool = True, pv=None, obs_verts=None,
                     obs_vert_radii=None, vlm_t=None, uv=None, obs_var=None):
    """LG's plain version: :func:`local_precision_plain`, then
    :func:`gram_plain`.  Returns ``(A, b)``."""
    a = local_precision_plain(rinv, obs_xyz, obs_radii, px, ii, localize,
                              pv=pv, obs_verts=obs_verts,
                              obs_vert_radii=obs_vert_radii, vlm_t=vlm_t,
                              uv=uv, obs_var=obs_var)
    return gram_plain(ye, innov, a, ii)


def obs_table(obs_xyz, obs_radii, rinv, innov, obs_verts=None,
              obs_vert_radii=None) -> torch.Tensor:
    """The kernel's per-ob inputs, one 32-byte row an ob: ``[No, 8]``
    float32 (x, y, z, radius, rinv, innov, level, level radius; the levels
    0 where not given)."""
    zero = torch.zeros_like(obs_radii)
    cols = [obs_xyz[:, 0], obs_xyz[:, 1], obs_xyz[:, 2], obs_radii, rinv,
            innov, zero if obs_verts is None else obs_verts,
            zero if obs_vert_radii is None else obs_vert_radii]
    return torch.stack([c.to(torch.float32) for c in cols], dim=1)


def check(ye: torch.Tensor) -> None:
    """Raise on what the kernel does not take (before any launch)."""
    if ye.dtype != torch.float32 or not ye.is_cuda:
        raise ValueError("LG takes float32 tensors on a CUDA device")
    if ye.dim() != 2 or ye.shape[1] < 1:
        raise ValueError(f"LG takes ye [No, M] of 1 member or more, not "
                         f"{tuple(ye.shape)}")


def local_gram_cuda(ye, table, px, ii, *, localize: bool = True, pv=None,
                    vlm_t=None, uv=None, obs_var=None, amat=None, b=None):
    """One LG launch over the ``C`` units of a chunk: ``ye [No, M]``,
    ``table`` of :func:`obs_table`, ``px [C, 3]``, ``ii [C, K]`` (int64),
    ``pv [C]`` (vertical), ``vlm_t [nvars, nv]`` with ``uv [C]`` and
    ``obs_var [No]`` (int64; varloc), all on one card, float32 and
    contiguous.  Writes ``A`` into ``amat [C, M, M]`` and ``b`` into ``b
    [C, M]`` (allocated where not given).  Returns ``(amat, b)``.  Raises
    on what the kernel does not take, before any launch."""
    check(ye)
    ye = ye.contiguous()
    c, k = ii.shape
    m = ye.shape[1]
    dev = ye.device
    if (table.dtype != torch.float32 or table.device != dev
            or tuple(table.shape) != (ye.shape[0], 8)):
        raise ValueError("LG takes the obs table as float32 [No, 8] on the "
                         "card of ye")
    if (vlm_t is None) != (uv is None) or (vlm_t is None) != (obs_var is
                                                                 None):
        raise ValueError("LG takes vlm_t, uv and obs_var together")
    for t, shape in ((amat, (c, m, m)), (b, (c, m))):
        if t is not None and (t.dtype != torch.float32 or t.device != dev
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"LG writes contiguous float32 {shape} outputs "
                             "on the card of ye")
    amat = (torch.empty((c, m, m), dtype=torch.float32, device=dev)
            if amat is None else amat)
    b = torch.empty((c, m), dtype=torch.float32, device=dev) if b is None \
        else b
    if not c:
        return amat, b
    px, ii = px.contiguous(), ii.contiguous()
    pv, vlm_t, uv, obs_var = (None if t is None else t.contiguous()
                              for t in (pv, vlm_t, uv, obs_var))
    if any(t is not None and t.dtype != torch.int64
           for t in (ii, uv, obs_var)):
        raise ValueError("LG takes ii, uv and obs_var as int64")
    ptr = lambda t: None if t is None else t.data_ptr()
    nv = 0 if vlm_t is None else vlm_t.shape[1]
    with torch.cuda.device(dev):
        rc = _build.lib().efa_letkf_gram(
            ye.data_ptr(), table.data_ptr(), ptr(obs_var), ptr(vlm_t), nv,
            ptr(px), ptr(pv), ptr(uv), ptr(ii), amat.data_ptr(),
            b.data_ptr(), c, k, m, int(localize),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "LG letkf_gram launch")
    _count(LAUNCHES_PER_CHUNK)
    return amat, b


def local_gram(ye, innov, rinv, obs_xyz, obs_radii, px, ii, *,
               localize: bool = True, pv=None, obs_verts=None,
               obs_vert_radii=None, vlm_t=None, uv=None, obs_var=None,
               table=None, amat=None, b=None):
    """``(A, b)`` of a chunk: LG on CUDA float32 tensors (``table``, the
    packed obs of :func:`obs_table`, made here where not given; the
    outputs into ``amat`` and ``b`` where given), else the plain version."""
    if not (ye.is_cuda and ye.dtype == torch.float32):
        return local_gram_plain(ye, innov, rinv, obs_xyz, obs_radii, px, ii,
                                localize=localize, pv=pv,
                                obs_verts=obs_verts,
                                obs_vert_radii=obs_vert_radii, vlm_t=vlm_t,
                                uv=uv, obs_var=obs_var)
    if table is None:
        table = obs_table(obs_xyz, obs_radii, rinv, innov,
                          obs_verts if pv is not None else None,
                          obs_vert_radii if pv is not None else None)
    return local_gram_cuda(ye, table, px, ii, localize=localize, pv=pv,
                           vlm_t=vlm_t, uv=uv, obs_var=obs_var, amat=amat,
                           b=b)


def _count(n: int) -> None:
    """``n`` launches of LG."""
    global launches
    with _count_lock:
        launches += n
