"""NS: the LETKF's batched Newton-Schulz inverse square root, its exit test
on the device.

Counterpart of the ``jax.lax.while_loop`` of
``efa_xray_tpu/assimilation/letkf_core.py`` (``_invsqrt_newton_schulz``
:340, loop :406), which is no Pallas kernel: on the TPU the exit test never
leaves the device.  :func:`invsqrt_newton_schulz_cuda` launches the CUDA
kernel of ``efa_xray_tpu_torch/csrc/newton_schulz.cu`` on CUDA float32
tensors (one launch per iteration up to the cap, two past 136 members, each
reading the previous iteration's error from device scalars, none read by
the host).  The plain
version is ``letkf_core._invsqrt_newton_schulz_plain`` (the loop that
reads each iteration's error back), which
``letkf_core._invsqrt_newton_schulz`` runs on CPU tensors and in float64.
Both return ``(A^{-1/2}, A^{-1}, iterations)``, the count a host int from
the plain version and a device scalar from the kernel.

:func:`newton_schulz_device_exit` is the kernel's control flow in torch,
every iteration up to the cap run and masked by the device-side test, with
no host read: the CPU's view of the kernel, which the tests hold against
the JAX package's ``while_loop``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from efa_xray_tpu_torch.ops import _build

# Largest ensemble the kernel takes (B1's bound), and the largest padded
# width whose Y, Z and T fit one CTA's shared memory (csrc/newton_schulz.cu
# smem_bytes); beyond it they stay in device memory, and each iteration is
# two launches over 64 x 64 tiles.
MAX_MEMBERS = 256
MAX_SMEM_BYTES = 232448

# Launches of the CUDA kernels (the start, one or two per iteration up to
# the cap, the end), not of the plain version, and the lock that guards
# the count.
launches = 0
_count_lock = threading.Lock()


def exit_thresholds(dtype: torch.dtype):
    """``(tol, quad)`` of the exit test in the working dtype, as the JAX
    package's comparisons take them: 100 eps, and 0.1."""
    npd = np.float32 if dtype == torch.float32 else np.float64
    return float(npd(100.0) * np.finfo(npd).eps), float(npd(0.1))


def smem_bytes(m: int) -> int:
    """Shared memory of one CTA holding Y, Z and T of ``m`` members
    (mirrors ``smem_bytes`` in ``csrc/newton_schulz.cu``)."""
    mp = -(-m // 4) * 4
    return 3 * mp * (mp + 4) * 4


def _scaled(a: torch.Tensor):
    """``(c, Y0 = A / c, Z0 = I)``: ``c`` the max abs row sum, an upper
    bound of the spectrum."""
    c = torch.amax(torch.sum(torch.abs(a), dim=-1), dim=-1)
    c = torch.clamp(c, min=1e-30)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return c, a / c[..., None, None], eye.expand(a.shape)


def _finish(z: torch.Tensor, c: torch.Tensor):
    inv_sqrt = z / torch.sqrt(c)[..., None, None]
    return inv_sqrt, inv_sqrt @ inv_sqrt


def newton_schulz_device_exit(a: torch.Tensor, iters: int):
    """The kernel's control flow in torch: ``iters`` iterations, each run
    only where the device-side exit test holds (the JAX package's rule),
    with no host read.  Returns ``(A^{-1/2}, A^{-1}, iterations)``, the
    count a 0-dim tensor."""
    tol, quad = exit_thresholds(a.dtype)
    c, y, z = _scaled(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    inf = torch.full((), float("inf"), dtype=a.dtype, device=a.device)
    err, prev = inf, inf
    run = torch.ones((), dtype=torch.bool, device=a.device)
    count = torch.zeros((), dtype=torch.int64, device=a.device)
    for _ in range(iters):
        run = run & (err > tol) & ~((err < quad) & (err > 0.5 * prev))
        zy = z @ y
        new_err = torch.amax(torch.abs(zy - eye))
        t = 1.5 * eye - 0.5 * zy
        y = torch.where(run, y @ t, y)
        z = torch.where(run, t @ z, z)
        prev, err = torch.where(run, err, prev), torch.where(run, new_err,
                                                             err)
        count = count + run.to(torch.int64)
    return (*_finish(z, c), count)


def invsqrt_newton_schulz_cuda(a: torch.Tensor, iters: int, tally=None):
    """Launch NS on a CUDA float32 batch ``a [C, M, M]`` (SPD): a start
    kernel, ``iters`` launches (twice as many where Y, Z and T do not fit
    one CTA's shared memory) and an end kernel, from one C call.  Returns
    ``(A^{-1/2}, A^{-1}, iterations)``, the count a device scalar (int64);
    ``tally`` (int64 ``[2]`` on the same card: summed, most) takes the
    count too, on the card.  Raises on what the kernel does not take,
    before any launch."""
    if a.dtype != torch.float32 or not a.is_cuda:
        raise ValueError("NS takes float32 tensors on a CUDA device")
    m = a.shape[-1]
    if a.shape[-2] != m or not 1 <= m <= MAX_MEMBERS:
        raise ValueError(f"NS takes square systems of 1 to {MAX_MEMBERS} "
                         f"members, not {tuple(a.shape[-2:])}")
    batch = a.shape[:-2]
    a3 = a.reshape(-1, m, m)
    ns = a3.shape[0]
    dev = a.device
    mp = -(-m // 4) * 4
    tol, quad = exit_thresholds(a.dtype)
    # _scaled's c and A / c, without its identity.
    c = torch.clamp(torch.amax(torch.sum(torch.abs(a3), dim=-1), dim=-1),
                    min=1e-30)
    y0 = (a3 / c[:, None, None]).contiguous()
    empty = lambda *shape, dtype=a.dtype: torch.empty(shape, dtype=dtype,
                                                      device=dev)
    out = empty(ns, m, m)
    yw, zw = empty(ns, mp, mp), empty(ns, mp, mp)
    in_smem = smem_bytes(m) <= MAX_SMEM_BYTES
    # T, then the second buffers of Y and Z (device-memory variant).
    tw = None if in_smem else empty(3, ns, mp, mp)
    err, run = empty(iters + 2), empty(iters + 1, dtype=torch.int32)
    count = empty(1, dtype=torch.int64)
    if tally is not None and (tally.device != dev
                              or tally.dtype != torch.int64
                              or tally.shape != (2,)):
        raise ValueError("NS's tally is int64 [2] on the batch's card")
    if ns:
        with torch.cuda.device(dev):
            rc = _build.lib().efa_newton_schulz(
                y0.data_ptr(), c.data_ptr(), out.data_ptr(), yw.data_ptr(),
                zw.data_ptr(), None if tw is None else tw.data_ptr(),
                err.data_ptr(), run.data_ptr(), count.data_ptr(),
                None if tally is None else tally.data_ptr(), ns, m, iters,
                tol, quad, torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "NS newton_schulz launch")
        _count((1 if in_smem else 2) * iters + 2)
    else:
        count.zero_()
    inv_sqrt = out.reshape(*batch, m, m)
    return inv_sqrt, inv_sqrt @ inv_sqrt, count[0]


def _count(n: int) -> None:
    """``n`` launches of NS."""
    global launches
    with _count_lock:
        launches += n
