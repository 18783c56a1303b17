"""What a body kernel's two large products compute: the product modes.

No single JAX counterpart.  The JAX package gives ``FilterConfig.
matmul_precision`` its meaning as a ``jax.default_matmul_precision`` context
around every solver trace (``efa_xray_tpu/assimilation/assimilation.py``
:420-450): on its TPU ``"default"``/``"bfloat16"`` run bf16 inputs in one
pass, ``"high"``/``"tensorfloat32"`` the tier between, ``"highest"``/
``"float32"`` multi-pass f32, and on the CPU every value runs f32.
``FilterConfig.mxu_bf16`` casts the two large products of the fused kernels
(B2, B2h, B3) to bf16 whatever the device (``efa_xray_tpu/ops/
ensrf_pallas_fused.py`` :191-205, :392-412, :821-828, :868-874).

Here a body kernel's two large products (D0 = X Y^T and the rank-B apply
X -= (g o U)^T Y, B2h's X -= V^T Y) run in one of three modes:

* ``"ieee"``: plain fp32 FMA;
* ``"tf32"``: tensor cores with the inputs rounded to TF32 (10 mantissa
  bits, to nearest, ties away from zero, as ``cvt.rna.tf32.f32``), fp32
  accumulation;
* ``"bf16"``: tensor cores with the inputs rounded to bf16 (to nearest
  even), fp32 accumulation.

:func:`product_mode` maps a configuration to a kernel's mode; everything
else (the mean update, the weights, the corrections, the tail, every torch
product outside the kernels) stays fp32 in every mode.  The plain versions
of the kernels round the same operands at the same points with
:func:`round_inputs`; so does the precision probe P.
"""

from __future__ import annotations

import torch

MODES = ("ieee", "tf32", "bf16")
# The body kernels whose two large products follow the mode, and those of
# them that take ``mxu_bf16`` (the JAX package's fused kernels).
BODY_KERNELS = ("B2", "B2h", "B3", "B4")
MXU_BF16_KERNELS = ("B2", "B2h", "B3")
# matmul_precision -> mode on the card.
_PRECISION_MODE = {None: "ieee", "highest": "ieee", "float32": "ieee",
                   "high": "tf32", "tensorfloat32": "tf32",
                   "default": "bf16", "bfloat16": "bf16"}


# The layouts of the tensor-core modes (mirrors of the helpers in
# csrc/mma_modes.cuh; the body kernels' smem_bytes use them).
STEP_BYTES = 32  # bytes of K per mma k-step: 8 TF32 or 16 bf16 values


def staged_values(mode: str, n: int) -> int:
    """Values of a row of ``n`` values padded with zeros to whole k-steps
    (8 in TF32, 16 in bf16)."""
    step = STEP_BYTES // (2 if mode == "bf16" else 4)
    return -(-n // step) * step


def mode_row_stride(mode: str, nmems: int) -> int:
    """Row stride (floats) of the X and Y buffers in a tensor-core mode:
    4 x odd, at least the staged K."""
    return 4 * ((staged_values(mode, nmems) // 4) | 1)


def u_stride(mode: str, tile: int) -> int:
    """Row stride (floats) of U: the tile, and 4 more in the tensor-core
    modes."""
    return tile if mode == "ieee" else tile + 4


def staged_y(y: torch.Tensor, mode: str) -> torch.Tensor:
    """The Y operand a body kernel takes in tensor-core mode ``mode``
    (``[..., M]`` float32 in): rounded once for every CTA, as
    :func:`round_inputs` rounds it; TF32 as float32 ``[..., M]``, bf16 as
    bfloat16 ``[..., staged_values(M)]`` with the pad zero, so that its
    rows copy 16 bytes at a time."""
    if mode == "tf32":
        return round_tf32(y)
    if mode != "bf16":
        raise ValueError(f"no staged Y in mode {mode!r}")
    out = torch.zeros((*y.shape[:-1], staged_values(mode, y.shape[-1])),
                      dtype=torch.bfloat16, device=y.device)
    out[..., :y.shape[-1]] = y
    return out


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` does.  The result is
    float32 with the low 13 mantissa bits cleared; inf and NaN pass
    through."""
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def round_inputs(x: torch.Tensor, mode: str) -> torch.Tensor:
    """The inputs as mode ``mode`` rounds them before its product, in
    ``x``'s dtype.  The kernels take float32: another dtype is rounded
    through float32."""
    if mode == "ieee":
        return x
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")
    if x.dtype != torch.float32:
        return round_inputs(x.to(torch.float32), mode).to(x.dtype)
    if mode == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    return round_tf32(x)


def product_mode(config, kernel: str, device) -> str:
    """The mode of ``kernel``'s two large products for ``config`` on
    ``device``: ``"ieee"``, ``"tf32"`` or ``"bf16"``.

    * a float64 update, and every kernel outside the body (``"B1"``,
      ``"B1h"``, the tail's applies): ``"ieee"``;
    * ``mxu_bf16`` on B2, B2h and B3: ``"bf16"`` on every device (the
      plain versions cast on the CPU, as the JAX kernels do in interpret
      mode);
    * otherwise ``matmul_precision`` on a CUDA device (``"high"``/
      ``"tensorfloat32"``: ``"tf32"``; ``"default"``/``"bfloat16"``:
      ``"bf16"``), and ``"ieee"`` on the CPU, whose products the JAX
      package's hint leaves in f32.
    """
    if config.dtype == "float64" or kernel not in BODY_KERNELS:
        return "ieee"
    if config.mxu_bf16 and kernel in MXU_BF16_KERNELS:
        return "bf16"
    if torch.device(device).type != "cuda":
        return "ieee"
    return _PRECISION_MODE[config.matmul_precision]
