"""Dataset metadata."""

from littlegan_tpu_torch.data.celeba import CELEBA_ATTR_NAMES  # noqa: F401
