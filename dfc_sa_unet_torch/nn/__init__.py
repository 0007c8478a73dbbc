from dfc_sa_unet_torch.nn.layers import BatchNorm, Conv, ConvTranspose2x2

__all__ = ["BatchNorm", "Conv", "ConvTranspose2x2"]
