"""efa_xray_tpu_torch: the ensemble square-root filter in PyTorch and CUDA.

The port of ``efa_xray_tpu`` (JAX, written for a TPU) to PyTorch on an
NVIDIA Hopper GPU.  Module paths mirror the JAX package's; each module's
docstring names its counterpart.  This first slice carries the localized
EnSRF update end to end: ``EnsembleState`` -> ``ObservationBatch`` ->
``EnSRF(..., device=...).update()``, with the tail's panel solve (kernel
B1, ``ops/tail_solve.py``) and the fused body (kernel B2,
``ops/ensrf_fused.py``) as CUDA kernels built from ``csrc/`` at first use.
On CPU tensors the kernels' plain-torch versions run.  The cycled
production filter rides on it: ``AdaptiveInflation`` (Anderson 2009,
learned on the filter's device), RTPS/RTPP, ``obs_order``,
``spatial_sort``, ``obs_chunk``, ``observation.bias.BiasCorrection``,
``postprocess.verification`` and the Lorenz-96 models in ``models``.  The
other two solvers of the JAX package run through the same API: the
stochastic ``EnKF`` and the ``LETKF``, as plain torch on every device, as
the JAX package runs them without Pallas.  The package never imports JAX.
"""

from efa_xray_tpu_torch.assimilation.adaptive_inflation import (
    AdaptiveInflation,
)
from efa_xray_tpu_torch.assimilation.assimilation import Assimilation
from efa_xray_tpu_torch.assimilation.enkf import EnKF
from efa_xray_tpu_torch.assimilation.ensrf import EnSRF
from efa_xray_tpu_torch.assimilation.letkf import LETKF
from efa_xray_tpu_torch.config import FilterConfig
from efa_xray_tpu_torch.observation.localization import (
    gaspari_cohn,
    haversine,
)
from efa_xray_tpu_torch.observation.observation import (
    Observation,
    ObservationBatch,
)
from efa_xray_tpu_torch.postprocess.postprocess import (
    obs_assimilation_statistics,
)
from efa_xray_tpu_torch.state.ensemble import EnsembleState
from efa_xray_tpu_torch.state.structure import StateStructure

__version__ = "0.1.0"

__all__ = [
    "AdaptiveInflation",
    "Assimilation",
    "EnKF",
    "EnSRF",
    "EnsembleState",
    "FilterConfig",
    "LETKF",
    "Observation",
    "ObservationBatch",
    "StateStructure",
    "gaspari_cohn",
    "haversine",
    "obs_assimilation_statistics",
]
