"""B1: serial EnSRF solve of one observation-space tail panel.

Counterpart of ``efa_xray_tpu/ops/tail_solve_pallas.py``
(``tail_panel_solve_pallas`` :161, kernel ``_make_tail_solve_kernel`` :46).
:func:`tail_panel_solve` launches the CUDA kernel of
``efa_xray_tpu_torch/csrc/tail_solve.cu`` on CUDA tensors and runs
:func:`tail_panel_solve_plain`, the same computation in plain torch, on CPU
tensors.  Outputs mean exactly what ``ensrf_core.tail_scan`` would give on
the panel (chordal weights, pure ensemble), with the post-update
diagnostics in closed form: row i right after ob i is
``(1 - beta kmat_i) ye``.
"""

from __future__ import annotations

import torch

from efa_xray_tpu_torch.ops import _build

# Launches of the CUDA kernel (not of the plain version).
launches = 0

# Largest dynamic shared memory a CTA may use on Hopper (227 KB).
MAX_SMEM_BYTES = 232448


def tail_panel_solve_plain(tail_mean, tail_perts, values, errors, assim,
                           weights=None, unbiased: bool = False):
    """Plain-torch B1: ``(tm, tp, ye, gain, sqrt, pm, pv, om, ov)``.
    ``weights[i, j]`` is the weight of ob i at panel row j (None = no
    localization)."""
    p, m = tail_perts.shape
    dtype = tail_perts.dtype
    vden = (m - 1) if unbiased else m
    tm = tail_mean.to(dtype).clone()
    tp = tail_perts.clone()
    vals = values.to(dtype)
    errs = errors.to(dtype)
    f_all = assim.to(dtype)
    nan = torch.tensor(float("nan"), dtype=dtype, device=tp.device)
    ye_rows, gain, sqrtc, pm, pv, om, ov = [], [], [], [], [], [], []
    for i in range(p):
        ye = tp[i].clone()
        mye = tm[i]
        mu = torch.sum(ye) / m
        varye = torch.sum((ye - mu) ** 2) / vden
        innov = vals[i] - mye
        kdenom = varye + errs[i]
        scale = 1.0 / (kdenom * (m - 1))
        beta = 1.0 / (1.0 + torch.sqrt(errs[i] / kdenom))
        kcov = tp @ ye
        kmat = (kcov * weights[i] if weights is not None else kcov) * scale
        f = f_all[i]
        tm = tm + (f * innov) * kmat
        tp = tp - ((f * beta) * kmat)[:, None] * ye[None, :]
        k_i = kmat[i]
        a = assim[i]
        shrink = 1.0 - beta * k_i
        ye_rows.append(ye)
        gain.append(f * innov * scale)
        sqrtc.append(f * beta * scale)
        pm.append(mye)
        pv.append(varye)
        om.append(torch.where(a, mye + k_i * innov, nan))
        ov.append(torch.where(a, shrink * shrink * varye, nan))
    st = torch.stack
    return (tm, tp, st(ye_rows), st(gain), st(sqrtc), st(pm), st(pv),
            st(om), st(ov))


def smem_bytes(p: int, m: int) -> int:
    """Shared memory the kernel needs for a [p, m] panel (odd row stride;
    mirrors ``smem_bytes`` in ``csrc/tail_solve.cu``)."""
    return 4 * (p * (m | 1) + p + m)


def tail_panel_solve_cuda(tail_mean, tail_perts, values, errors, assim,
                          weights=None, unbiased: bool = False):
    """Launch B1 on CUDA tensors (float32); same returns as the plain
    version.  Raises when the panel does not fit in shared memory."""
    global launches
    p, m = tail_perts.shape
    dev = tail_perts.device
    f32 = torch.float32
    if smem_bytes(p, m) > MAX_SMEM_BYTES:
        raise ValueError(
            f"tail panel [{p}, {m}] needs {smem_bytes(p, m)} B of shared "
            f"memory, more than the {MAX_SMEM_BYTES} B a CTA may use: "
            "use a smaller tail_panel")
    ins = [tail_mean, tail_perts, values, errors]
    if weights is not None:
        ins.append(weights)
    for t in ins:
        if t.device != dev or t.dtype != f32:
            raise ValueError("B1 takes float32 tensors on one CUDA device")
    if weights is not None and weights.shape != (p, p):
        raise ValueError("B1 weights must be [P, P]")
    tm_in = tail_mean.contiguous()
    tp_in = tail_perts.contiguous()
    vals = values.contiguous()
    errs = errors.contiguous()
    am = assim.to(device=dev, dtype=torch.uint8).contiguous()
    w = weights.contiguous() if weights is not None else None
    for t, n in ((tm_in, p), (vals, p), (errs, p), (am, p)):
        if t.shape != (n,):
            raise ValueError("B1 per-ob inputs must be [P]")
    tm = torch.empty(p, dtype=f32, device=dev)
    tp = torch.empty((p, m), dtype=f32, device=dev)
    ye = torch.empty((p, m), dtype=f32, device=dev)
    vec = [torch.empty(p, dtype=f32, device=dev) for _ in range(6)]
    err = _build.lib().efa_tail_solve(
        tm_in.data_ptr(), tp_in.data_ptr(), vals.data_ptr(), errs.data_ptr(),
        am.data_ptr(), None if w is None else w.data_ptr(), p, m,
        int(bool(unbiased)), tm.data_ptr(), tp.data_ptr(), ye.data_ptr(),
        *(v.data_ptr() for v in vec),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "B1 tail_solve launch")
    launches += 1
    return (tm, tp, ye, *vec)


def tail_panel_solve(tail_mean, tail_perts, values, errors, assim,
                     weights=None, unbiased: bool = False):
    """B1 dispatch: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if tail_perts.is_cuda:
        return tail_panel_solve_cuda(tail_mean, tail_perts, values, errors,
                                     assim, weights, unbiased)
    if tail_perts.device.type != "cpu":
        raise ValueError(f"B1 runs on CUDA or CPU, not {tail_perts.device}")
    return tail_panel_solve_plain(tail_mean, tail_perts, values, errors,
                                  assim, weights, unbiased)
