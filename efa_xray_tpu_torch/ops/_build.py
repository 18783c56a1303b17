"""Build and load the CUDA kernels of :mod:`efa_xray_tpu_torch.ops`.

No JAX counterpart: the Pallas kernels were compiled by JAX itself.  Here
the sources in ``efa_xray_tpu_torch/csrc/*.cu`` are compiled with ``nvcc``
for ``sm_90a``, one ``nvcc`` per source, all started together, and linked
into one shared library with a plain C interface, at first use; it is
loaded with :mod:`ctypes`.  The library goes to
``build/efa_xray_tpu_torch/`` beside the package, named by a hash of the
sources, their headers (``*.cuh``) and the flags, so an edited source
rebuilds and an unchanged one loads the existing file.  A failed build or
load raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "efa_xray_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

# Seconds the last build took (0.0 when the library was already built).
last_build_seconds = 0.0

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# argtypes of every C entry point; pointers and the stream as c_void_p.
_SIGNATURES = {
    "efa_tail_solve_smem": [_I] * 4,
    "efa_tail_launch": [_P] * 10 + [_F] + [_I] * 5 + [_P] * 13,
    "efa_fused_launch": [_P] * 8 + [_I] * 11 + [_P] * 3,
    "efa_grid_launch": [_P] * 10 + [_I] * 8 + [_P] * 3,
    "efa_grid_ctas_per_sm": [_I] * 4,
    "efa_grid_abi": [],
    "efa_precision_mm": [_P] * 5 + [_I] * 4 + [_P],
    "efa_newton_schulz": [_P] * 9 + [_I] * 3 + [_F] * 3 + [_P],
    "efa_ns_in_smem": [_I],
    "efa_ns_work_floats": [_I, _I],
    "efa_letkf_gram": [_P] * 4 + [_I] + [_P] * 6 + [_I] * 4 + [_P],
}
# Entry points whose result is not a C int.
_RESTYPES = {"efa_ns_work_floats": ctypes.c_longlong}


def sources():
    return sorted(CSRC.glob("*.cu"))


def headers():
    return sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libefa_kernels_{h.hexdigest()[:16]}.so"


def _run(cmd) -> None:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                           f"{res.stdout}\n{res.stderr}")


def build() -> Path:
    """Compile the kernels unless the library for these sources exists."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        last_build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
                             for src, obj in zip(sources(), objs))]
        failed = []
        for cmd, proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{stdout}\n{stderr}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib_tmp = os.path.join(tmp, out.name)
        _run([nvcc, *NVCC_FLAGS, "-shared", "-o", lib_tmp, *objs])
        # Atomic rename: a concurrent process never loads a partial file.
        os.replace(lib_tmp, out)
    last_build_seconds = time.perf_counter() - t0
    return out


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = _RESTYPES.get(name, ctypes.c_int)
    return handle


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
