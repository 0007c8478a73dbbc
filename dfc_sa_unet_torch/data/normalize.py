"""uint8 images -> normalised float (counterpart of dfc_sa_unet_tpu/data/loader.py:26-34).

ToTensor + Normalize(ImageNet) as one affine in f32 on the device:
((x - 255*mean) / (255*std)), then cast.  The constants are copied from
dfc_sa_unet_tpu/data/transforms.py.
"""

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_MEAN = torch.tensor(IMAGENET_MEAN, dtype=torch.float32) * 255.0
_STD = torch.tensor(IMAGENET_STD, dtype=torch.float32) * 255.0


def normalize(images_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [..., 3] (channels last) -> normalised ``dtype`` of the same shape."""
    x = images_u8.float()
    mean, std = _MEAN.to(x.device), _STD.to(x.device)
    return ((x - mean) / std).to(dtype)
