"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, dense rates), and the least time a piece of work needs."""

from __future__ import annotations

PEAK_TFLOPS = {"fp32": 67.0, "tf32": 495.0, "bf16": 989.0}
HBM_TBPS = 3.35


def bound_s(ops: float, nbytes: float, peak: str = "fp32") -> float:
    """The least seconds the card could take: the larger of ``ops`` at the
    peak rate of ``peak`` and ``nbytes`` at the HBM rate."""
    return max(ops / (PEAK_TFLOPS[peak] * 1e12), nbytes / (HBM_TBPS * 1e12))
