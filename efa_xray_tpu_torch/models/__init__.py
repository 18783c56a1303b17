from efa_xray_tpu_torch.models import cycling  # noqa: F401
from efa_xray_tpu_torch.models import l96_2d  # noqa: F401
from efa_xray_tpu_torch.models import lorenz96  # noqa: F401
from efa_xray_tpu_torch.models import swe  # noqa: F401
