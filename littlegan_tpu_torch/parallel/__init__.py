"""Training over several cards: one process per card (``torch.distributed``)
over a data mesh or a spatial ('data', 'model') mesh, and one replica per
card for inference."""

from littlegan_tpu_torch.parallel.infer import data_parallel_infer, infer_mesh_devices, pad_rows  # noqa: F401
from littlegan_tpu_torch.parallel.mesh import (  # noqa: F401
    DataGroup, SpatialGroup, data_group, initialize_distributed, spatial_group,
)
from littlegan_tpu_torch.parallel.train import GradSync, local_draws, replicate_state, shard_local_batch  # noqa: F401
from littlegan_tpu_torch.parallel.zero import (  # noqa: F401
    Zero1, check_shard_dense, check_shard_opt_state, state_bytes_report,
)
