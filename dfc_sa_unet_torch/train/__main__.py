"""``python -m dfc_sa_unet_torch.train``: see train/cli.py."""

from dfc_sa_unet_torch.train.cli import main

main()
