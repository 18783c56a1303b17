from efa_xray_tpu_torch.postprocess.postprocess import (  # noqa: F401
    obs_assimilation_statistics,
)
from efa_xray_tpu_torch.postprocess.verification import (  # noqa: F401
    crps,
    desroziers_diagnostics,
    field_verification,
    innovation_consistency,
    rank_histogram,
)
from efa_xray_tpu_torch.postprocess.sensitivity import (  # noqa: F401
    ensemble_sensitivity,
    greedy_obs_selection,
    observation_impact,
    region_mean_metric,
)
