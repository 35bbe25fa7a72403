"""Interoperability: the JAX package's parameter sets (``jax_params``), the
reference repo's tf.train.Checkpoints both ways (``reference_checkpoint``),
TF-Serving SavedModels (``savedmodel``) and ``torch.export`` artifacts of
the inference entry points (``torch_export``)."""

from littlegan_tpu_torch.compat.reference_checkpoint import (
    convert_reference_checkpoint,
    export_reference_checkpoint,
    read_reference_variables,
    variables_to_params,
    variables_to_train_state,
)

__all__ = [
    "convert_reference_checkpoint",
    "export_reference_checkpoint",
    "read_reference_variables",
    "variables_to_params",
    "variables_to_train_state",
]
