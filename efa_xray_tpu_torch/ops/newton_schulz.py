"""NS: the LETKF's batched Newton-Schulz inverse square root, its exit test
on the device, in one launch a solve.

Counterpart of the ``jax.lax.while_loop`` of
``efa_xray_tpu/assimilation/letkf_core.py`` (``_invsqrt_newton_schulz``
:340, loop :406), which is no Pallas kernel: on the TPU the exit test never
leaves the device.  :func:`solve` launches the CUDA kernel of
``efa_xray_tpu_torch/csrc/newton_schulz.cu`` on CUDA float32 tensors: one
cooperative launch a solve, whose CTAs fold each iteration's error into a
device slot and read it back after a grid-wide barrier, so none of them
runs an iteration past the exit and the host reads nothing.  Its end
writes ``scale A^{-1/2}`` and, on request, ``A^{-1} b``: what the LETKF's
solve uses (``W = sqrt(M - 1) A^{-1/2}``, ``wbar = A^{-1} b``).  It forms
``wbar`` as ``S (S b)`` (``S = A^{-1/2}``), where the JAX package forms
``(S S) b``: the same value, rounded in another order.  The plain version
is ``letkf_core._invsqrt_newton_schulz_plain`` (the loop that reads each
iteration's error back) and the two products after it, which
``letkf_core._newton_schulz_weights`` runs on CPU tensors and in
float64.

:func:`newton_schulz_device_exit` is the kernel's control flow in torch:
every iteration up to the cap, each taking effect only where the test on
the previous errors holds (the kernel stops there instead), with no host
read: the CPU's view of the kernel, which the tests hold against the JAX
package's ``while_loop``.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from efa_xray_tpu_torch.ops import _build

# The shared memory a CTA may use (csrc/newton_schulz.cu): where Y, Z and
# T of one system do not fit, they stay in device memory (any ensemble).
MAX_SMEM_BYTES = 232448

# Launches of the CUDA kernel (one a solve: LAUNCHES_PER_SOLVE), not of the
# plain version, and the lock that guards the count.
LAUNCHES_PER_SOLVE = 1
launches = 0
_count_lock = threading.Lock()


def exit_thresholds(dtype: torch.dtype):
    """``(tol, quad)`` of the exit test in the working dtype, as the JAX
    package's comparisons take them: 100 eps, and 0.1."""
    npd = np.float32 if dtype == torch.float32 else np.float64
    return float(npd(100.0) * np.finfo(npd).eps), float(npd(0.1))


def smem_bytes(m: int) -> int:
    """Shared memory of one CTA holding Y, Z and T of ``m`` members, rows
    ``mq + 4`` floats apart, ``mq`` the width padded to 4 (to 8 past 128):
    ``make_plan``'s in ``csrc/newton_schulz.cu``, whose ``efa_ns_in_smem``
    picks the variant."""
    mq = -(-m // 4) * 4
    if mq > 128:
        mq = -(-m // 8) * 8
    return 12 * mq * (mq + 4)


# Static shared memory of the device-memory variant: two slices of 16
# rows of A and B, 68 floats apart (csrc/newton_schulz.cu tile64).
DEVICE_VARIANT_SMEM_BYTES = 2 * 2 * 16 * 68 * 4
# What efa_ns_in_smem keeps free beside the shared-memory variant's plan.
STATIC_RESERVE = 1024


def launch_smem_bytes(m: int) -> int:
    """Shared memory of one NS CTA at ``m`` members: the shared-memory
    variant's where it fits with ``STATIC_RESERVE`` beside it, else the
    device-memory variant's, which no ensemble grows."""
    if smem_bytes(m) + STATIC_RESERVE <= MAX_SMEM_BYTES:
        return smem_bytes(m)
    return DEVICE_VARIANT_SMEM_BYTES


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
    """The kernel's control flow in torch: the exit test of iteration
    ``i`` on the errors of the two before it, the same in every CTA, and
    the iteration taking effect only where it holds (the kernel's CTAs
    leave their loop there), with no host read.  Returns ``(A^{-1/2},
    A^{-1}, iterations)``, the count a 0-dim tensor."""
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


def check(a: torch.Tensor, b=None) -> None:
    """Raise on what the kernel does not take (before any launch)."""
    if a.dtype != torch.float32 or not a.is_cuda:
        raise ValueError("NS takes float32 tensors on a CUDA device")
    m = a.shape[-1]
    if a.dim() != 3 or a.shape[-2] != m or m < 1:
        raise ValueError(f"NS takes [C, M, M] systems of 1 member or more, "
                         f"not {tuple(a.shape)}")
    if b is not None and (b.dtype != a.dtype or b.device != a.device
                          or tuple(b.shape) != tuple(a.shape[:2])):
        raise ValueError("NS takes b as float32 [C, M] beside A")


def _scratch(ws, name: str, n: int, dtype, dev) -> torch.Tensor:
    """A flat scratch tensor of ``n`` elements: fresh, or kept in the dict
    ``ws`` under ``name`` and used again by the next solve of that size."""
    if ws is None:
        return torch.empty(n, dtype=dtype, device=dev)
    t = ws.get(name)
    if t is None or t.numel() != n or t.dtype != dtype:
        t = ws[name] = torch.empty(n, dtype=dtype, device=dev)
    return t


def solve(a: torch.Tensor, iters: int, *, b=None, scale: float = 1.0,
          out=None, wbar_out=None, tally=None, ws=None):
    """One NS launch on a CUDA float32 batch ``a [C, M, M]`` (SPD,
    contiguous): writes ``scale A^{-1/2}`` into ``out`` and, when given,
    ``A^{-1} b`` into ``wbar_out`` (``b [C, M]``).  ``out`` is allocated
    where not given.  ``scale`` is rounded to float32 (``sqrt(M - 1)`` of
    the float32 ``M - 1``, as the JAX package takes it, for ``W``).
    Returns ``(out, wbar_out, count)``, ``count`` the iterations run (int64
    ``[1]`` on the card); ``tally`` (int64 ``[2]`` on the same card:
    summed, most) takes the count too, on the card.  ``ws``, a dict, keeps
    the work buffers for the next solve on the same stream.  Raises on
    what the kernel does not take, before any launch."""
    check(a, b)
    ns, m = a.shape[0], a.shape[-1]
    dev = a.device
    if tally is not None and (tally.device != dev
                              or tally.dtype != torch.int64
                              or tuple(tally.shape) != (2,)):
        raise ValueError("NS's tally is int64 [2] on the batch's card")
    if wbar_out is not None and b is None:
        raise ValueError("NS writes A^{-1} b only where b is given")
    for t, shape in ((out, (ns, m, m)), (wbar_out, (ns, m))):
        if t is not None and (t.dtype != torch.float32 or t.device != dev
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"NS writes contiguous float32 {shape} outputs "
                             "on the batch's card")
    out = (torch.empty((ns, m, m), dtype=torch.float32, device=dev)
           if out is None else out)
    count = _scratch(ws, "count", 1, torch.int64, dev)
    if not ns:
        count.zero_()
        return out, wbar_out, count
    tol, quad = exit_thresholds(a.dtype)
    a = a.contiguous()
    b = None if b is None else b.contiguous()
    lib = _build.lib()
    work = _scratch(ws, "work", lib.efa_ns_work_floats(ns, m), torch.float32,
                    dev)
    cbuf = _scratch(ws, "c", ns, torch.float32, dev)
    scratch = _scratch(ws, "scratch", 2 + iters, torch.int32, dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        rc = lib.efa_newton_schulz(
            a.data_ptr(), ptr(b), out.data_ptr(), ptr(wbar_out),
            work.data_ptr(), cbuf.data_ptr(), scratch.data_ptr(),
            count.data_ptr(), ptr(tally), ns, m, iters, tol, quad,
            float(np.float32(scale)),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "NS newton_schulz launch")
    _count(LAUNCHES_PER_SOLVE)
    return out, wbar_out, count


def invsqrt_newton_schulz_cuda(a: torch.Tensor, iters: int, tally=None):
    """NS on a CUDA float32 batch ``a [..., M, M]`` (SPD): one launch, then
    ``A^{-1} = S S`` in torch.  Returns ``(A^{-1/2}, A^{-1}, iterations)``,
    the count a device scalar (int64); ``tally`` as :func:`solve` takes it.
    Raises on what the kernel does not take, before any launch."""
    m = a.shape[-1]
    batch = a.shape[:-2]
    a3 = a.reshape(-1, *a.shape[-2:]) if a.dim() != 3 else a
    s, _, count = solve(a3, iters, tally=tally)
    s = s.reshape(*batch, m, m)
    return s, s @ s, count[0]


def _count(n: int) -> None:
    """``n`` launches of NS."""
    global launches
    with _count_lock:
        launches += n
