"""Data parallelism over cards: one process per card (``torch.distributed``)
for training, one replica per card for inference."""

from littlegan_tpu_torch.parallel.infer import data_parallel_infer, infer_mesh_devices, pad_rows  # noqa: F401
from littlegan_tpu_torch.parallel.mesh import DataGroup, data_group, initialize_distributed  # noqa: F401
from littlegan_tpu_torch.parallel.train import GradSync, local_draws, replicate_state, shard_local_batch  # noqa: F401
from littlegan_tpu_torch.parallel.zero import (  # noqa: F401
    Zero1, check_shard_dense, check_shard_opt_state, state_bytes_report,
)
