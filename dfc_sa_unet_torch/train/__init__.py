"""Training: the optimiser and the Trainer."""

from dfc_sa_unet_torch.train.trainer import Trainer

__all__ = ["Trainer"]
