"""P: the precision probe.  What does an f32 matrix product compute in each
precision the card offers?

Counterpart of ``benchmarks/precision_probe.py``: its kernel ``_make_kernel``
:29 and ``mm`` :44, and ``main`` :57.  The TPU probe asked how the matrix
unit takes f32 inputs ("default" single-pass bf16, explicit bf16, and
"highest").  Here the three modes are Hopper's:

* ``"ieee"``: plain fp32 FMA (what "highest" asks for), 8 x 8 register
  tiles behind a ``cp.async`` ring;
* ``"tf32"``: tensor cores (``wgmma``) with the inputs rounded to TF32 (10
  mantissa bits, to nearest, ties away from zero), fp32 accumulation: the
  counterpart of the TPU's single-pass default;
* ``"bf16"``: tensor cores (``wgmma``) with the inputs rounded to bf16 (to
  nearest even), fp32 accumulation.

:func:`mm` launches the CUDA kernel of
``efa_xray_tpu_torch/csrc/precision_probe.cu`` on CUDA tensors, or runs
:func:`mm_plain` (the same rounding, then a product) on CPU tensors.
:func:`probe` holds each mode against a float64 oracle, as the TPU probe
did.  Run ``python -m efa_xray_tpu_torch.ops.precision_probe`` on a
machine with a GPU to print its dict as JSON.  Nothing in the filter calls
this module: it records what each precision costs.  Its rounding lives in
:mod:`efa_xray_tpu_torch.ops.precision`, where the body kernels' product
modes (B2-B4) take it from.
"""

from __future__ import annotations

import json
import threading
import time

import numpy as np
import torch

from efa_xray_tpu_torch.ops import _build
from efa_xray_tpu_torch.ops.precision import MODES, round_inputs
from efa_xray_tpu_torch.state.ensemble import default_device

_MODE_ID = {m: i for i, m in enumerate(MODES)}
# Every size must be a multiple of TILE; the kernels zero-fill and mask
# their edge tiles beyond that (csrc/precision_probe.cu kSizeMultiple).
TILE = 16
# Padding of the rounded scratch copies the tensor-core modes read
# (csrc/precision_probe.cu kRowPad, kKPad): rows of A and of B^T, and k.
ROW_PAD = 128
K_PAD = 64

# Launches of the CUDA kernel (not of the plain version), in all and by
# mode.
launches = 0
launches_by_mode = dict.fromkeys(MODES, 0)
# Guards the counters against launches from several threads.
_count_lock = threading.Lock()


def mm_plain(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """Plain-torch P: round the inputs as ``mode`` does, then a float32
    product.  On the card this needs ``torch.backends.cuda.matmul.
    allow_tf32`` off to stay a true float32 product."""
    return round_inputs(a, mode) @ round_inputs(b, mode)


def _check(a, b, mode):
    if mode not in _MODE_ID:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"P takes [n, k] @ [k, m], got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")


def _ceil_to(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def scratch_shapes(n: int, k: int, m: int):
    """Shapes of the rounded copies a tensor-core mode reads: A padded to
    ``[ceil(n, 128), ceil(k, 64)]`` and B transposed and padded to
    ``[ceil(m, 128), ceil(k, 64)]`` (mirrors ``run_tensor`` in the .cu)."""
    kpad = _ceil_to(k, K_PAD)
    return (_ceil_to(n, ROW_PAD), kpad), (_ceil_to(m, ROW_PAD), kpad)


def mm_cuda(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """Launch P on CUDA float32 tensors whose sizes are multiples of 16,
    square or not."""
    _check(a, b, mode)
    n, k = a.shape
    m = b.shape[1]
    if n == 0 or k == 0 or m == 0 or n % TILE or k % TILE or m % TILE:
        raise ValueError(f"P needs sizes that are positive multiples of "
                         f"{TILE}, got n={n}, k={k}, m={m}")
    dev = a.device
    if (not a.is_cuda or b.device != dev or a.dtype != torch.float32
            or b.dtype != torch.float32):
        raise ValueError("P takes float32 tensors on one CUDA device")
    a, b = a.contiguous(), b.contiguous()
    # The kernels copy 16 bytes at a time.
    if a.data_ptr() % 16:
        a = a.clone()
    if b.data_ptr() % 16:
        b = b.clone()
    c = torch.empty((n, m), dtype=torch.float32, device=dev)
    ar = bt = None
    if mode != "ieee":
        sdtype = torch.bfloat16 if mode == "bf16" else torch.float32
        sa, sb = scratch_shapes(n, k, m)
        ar = torch.empty(sa, dtype=sdtype, device=dev)
        bt = torch.empty(sb, dtype=sdtype, device=dev)
    # The C entry sets its attributes on, and launches onto, the current
    # device: make it the tensors' one.
    with torch.cuda.device(dev):
        err = _build.lib().efa_precision_mm(
            a.data_ptr(), b.data_ptr(), c.data_ptr(),
            None if ar is None else ar.data_ptr(),
            None if bt is None else bt.data_ptr(), n, k, m, _MODE_ID[mode],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, f"P precision_probe launch ({mode})")
    _count(mode)
    return c


def _count(mode: str) -> None:
    """One launch of P in ``mode``."""
    global launches
    with _count_lock:
        launches += 1
        launches_by_mode[mode] += 1


def mm(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """P dispatch: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    _check(a, b, mode)
    if a.is_cuda:
        return mm_cuda(a, b, mode)
    if a.device.type != "cpu":
        raise ValueError(f"P runs on CUDA or CPU, not {a.device}")
    return mm_plain(a, b, mode)


def _seconds(fn, device: torch.device, reps: int) -> float:
    """Mean seconds of ``fn`` over ``reps`` runs after one warm-up: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def probe(n: int = 512, k: int = 512, time_n: int = 1024, reps: int = 8,
          device=None) -> dict:
    """Each mode's [n, k] @ [k, n] product against a float64 oracle, as
    ``benchmarks/precision_probe.py`` ``main`` measures the TPU's:
    ``<mode>_rms_err_over_scale``, whether two modes agree bit for bit,
    and ``<mode>_<time_n>_seconds`` for a [time_n, time_n] product.
    ``device`` defaults to the card; pass ``"cpu"`` for the plain
    versions (whose times are the CPU's)."""
    dev = default_device(device)
    rng = np.random.default_rng(0)
    a32 = rng.standard_normal((n, k)).astype(np.float32)
    b32 = rng.standard_normal((k, n)).astype(np.float32)
    oracle = a32.astype(np.float64) @ b32.astype(np.float64)
    scale = float(np.sqrt(np.mean(oracle ** 2)))
    a = torch.from_numpy(a32).to(dev)
    b = torch.from_numpy(b32).to(dev)
    out = {"n": n, "k": k, "device": (torch.cuda.get_device_name(dev)
                                      if dev.type == "cuda" else "cpu")}
    res = {}
    for mode in MODES:
        r = mm(a, b, mode).double().cpu().numpy()
        res[mode] = r
        out[f"{mode}_rms_err_over_scale"] = float(
            np.sqrt(np.mean((r - oracle) ** 2)) / scale)
    for i, m1 in enumerate(MODES):
        for m2 in MODES[i + 1:]:
            out[f"{m1}_equals_{m2}_bitwise"] = bool(
                np.array_equal(res[m1], res[m2]))
    at = torch.from_numpy(rng.standard_normal((time_n, time_n))
                          .astype(np.float32)).to(dev)
    bt = torch.from_numpy(rng.standard_normal((time_n, time_n))
                          .astype(np.float32)).to(dev)
    for mode in MODES:
        out[f"{mode}_{time_n}_seconds"] = _seconds(
            lambda: mm(at, bt, mode), dev, reps)
    return out


if __name__ == "__main__":
    print(json.dumps(probe()), flush=True)
