from efa_xray_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    pad_to_multiple,
    shard_state_array,
)
from efa_xray_tpu_torch.parallel.sharded import ensrf_update_sharded  # noqa: F401
