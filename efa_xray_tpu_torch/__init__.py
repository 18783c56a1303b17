"""efa_xray_tpu_torch: the ensemble square-root filter in PyTorch and CUDA.

The port of ``efa_xray_tpu`` (JAX, written for a TPU) to PyTorch on an
NVIDIA Hopper GPU.  Module paths mirror the JAX package's; each module's
docstring names its counterpart.  The localized EnSRF update runs end to
end, ``EnsembleState`` -> ``ObservationBatch`` -> ``EnSRF(...,
device=...).update()`` (or the module-level ``update``), with every TPU
kernel of the JAX package written by hand in CUDA C++ for Hopper
(``csrc/``, built at first use): the tail's panel solve B1
(``ops/tail_solve.py``), the fused body B2 (``ops/ensrf_fused.py``) and
the grid bodies B3/B4 (``ops/ensrf_grid.py``).  On CPU tensors the
kernels' plain-torch versions run.  Around it: the cycled production
filter (``AdaptiveInflation``, RTPS/RTPP, ``obs_order``,
``spatial_sort``, ``obs_chunk``, ``observation.bias.BiasCorrection``,
``postprocess.verification``), the other two solvers (the stochastic
``EnKF`` and the ``LETKF``, plain torch as the JAX package runs them
without Pallas), the cycling OSSE (``models.cycling.CyclingHarness`` with
the Lorenz-96 and shallow-water models, its EnSRF analysis on the
kernels' route), the observation pipeline (``from_dataframe``,
``observation.thinning``, ``desroziers_diagnostics``), and the
file-driven entry point: the CLI (``python -m efa_xray_tpu_torch.cli``,
the console script ``efa-xray-tpu-torch``), netCDF I/O that reads and
writes the JAX package's files (``utils.ncio``, ``save_to_disk`` /
``from_netcdf``, the inflation files), ensemble sensitivity and
observation targeting (``postprocess.sensitivity``) and the viewer.
Entry points run on the card unless the caller passes ``device="cpu"``
(``--device cpu`` on the CLI).  The package never imports JAX.
"""

from efa_xray_tpu_torch.state.structure import StateStructure
from efa_xray_tpu_torch.state.ensemble import EnsembleState
from efa_xray_tpu_torch.observation.observation import (
    Observation,
    ObservationBatch,
)
from efa_xray_tpu_torch.observation.localization import (
    distance_to_point,
    gaspari_cohn,
    haversine,
)
from efa_xray_tpu_torch.assimilation.assimilation import Assimilation, update
from efa_xray_tpu_torch.assimilation.enkf import EnKF
from efa_xray_tpu_torch.assimilation.ensrf import EnSRF
from efa_xray_tpu_torch.assimilation.letkf import LETKF
from efa_xray_tpu_torch.assimilation.adaptive_inflation import (
    AdaptiveInflation,
)
from efa_xray_tpu_torch.postprocess.postprocess import (
    obs_assimilation_statistics,
)
from efa_xray_tpu_torch.config import FilterConfig

__version__ = "0.1.0"

# The JAX package's __all__, name for name.
__all__ = [
    "StateStructure",
    "EnsembleState",
    "Observation",
    "ObservationBatch",
    "gaspari_cohn",
    "haversine",
    "distance_to_point",
    "Assimilation",
    "EnKF",
    "EnSRF",
    "LETKF",
    "AdaptiveInflation",
    "update",
    "obs_assimilation_statistics",
    "FilterConfig",
]
