from dfc_sa_unet_torch.nn.layers import (
    BatchNorm,
    Conv,
    ConvTranspose,
    ConvTranspose2x2,
    Dense,
    GroupNorm,
    LayerNorm,
    WSConv,
)

__all__ = ["BatchNorm", "Conv", "ConvTranspose", "ConvTranspose2x2", "Dense", "GroupNorm", "LayerNorm", "WSConv"]
