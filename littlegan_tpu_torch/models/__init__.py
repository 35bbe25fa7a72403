"""The LittleGAN model family (nn.Modules sharing their parts)."""

from littlegan_tpu_torch.models.littlegan import (  # noqa: F401
    LittleGAN,
    init_params,
    param_count,
    s2d_active,
)
