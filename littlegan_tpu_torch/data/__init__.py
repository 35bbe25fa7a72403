"""Datasets: CelebA (native libjpeg decode, else PIL) and a synthetic one."""

from littlegan_tpu_torch.data.celeba import CELEBA_ATTR_NAMES, CelebA, epoch_batch_order  # noqa: F401
from littlegan_tpu_torch.data.synthetic import SyntheticDataset  # noqa: F401
