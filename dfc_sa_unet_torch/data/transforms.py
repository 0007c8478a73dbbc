"""Paired image+mask transforms (a copy of dfc_sa_unet_tpu/data/transforms.py;
reference utils/data_loader.py:10-73).  PIL is imported by the transforms
that use it, so the package imports without.

Host-side work stays in uint8 (PIL); the float conversion, /255 scaling,
mask binarization and ImageNet normalization all happen **on device**
(see data/normalize.py) - shipping uint8 over PCIe is 4x
cheaper than float32 and numerically identical to the reference's
ToTensor+Normalize order.

Every random transform takes an explicit numpy Generator, so a sample's
augmentation depends on its seed alone.
"""

from typing import Optional, Sequence, Tuple

import numpy as np

from dfc_sa_unet_torch.data.normalize import IMAGENET_MEAN, IMAGENET_STD  # noqa: F401  (re-exported)


class PairedCompose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, mask, rng: Optional[np.random.Generator] = None):
        for t in self.transforms:
            img, mask = t(img, mask, rng=rng)
        return img, mask


class PairedResize:
    """img BILINEAR, mask NEAREST (reference utils/data_loader.py:25-33)."""

    def __init__(self, size: Tuple[int, int]):
        self.size = tuple(size)

    def __call__(self, img, mask, rng=None):
        from PIL import Image

        return img.resize(self.size, Image.BILINEAR), mask.resize(self.size, Image.NEAREST)


class PairedRandomRotation:
    """With p=0.5, rotate both by U(-degrees, degrees); img BILINEAR,
    mask NEAREST, zero fill (reference utils/data_loader.py:35-45)."""

    def __init__(self, degrees: float = 90.0, p: float = 0.5):
        self.degrees = degrees
        self.p = p

    def __call__(self, img, mask, rng=None):
        from PIL import Image

        rng = rng or np.random.default_rng()
        if rng.random() < self.p:
            angle = float(rng.uniform(-self.degrees, self.degrees))
            img = img.rotate(angle, Image.BILINEAR)
            mask = mask.rotate(angle, Image.NEAREST)
        return img, mask


class PairedRandomHorizontalFlip:
    """p=0.5 joint horizontal flip (reference utils/data_loader.py:47-53)."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, img, mask, rng=None):
        from PIL import Image

        rng = rng or np.random.default_rng()
        if rng.random() < self.p:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            mask = mask.transpose(Image.FLIP_LEFT_RIGHT)
        return img, mask


class PairedToArray:
    """PIL -> uint8 numpy: image HWC, mask HW (binarization happens on
    device; reference ExtToTensor binarizes at (v/255) > 0.5, i.e. v >= 128)."""

    def __call__(self, img, mask, rng=None):
        return np.asarray(img, dtype=np.uint8), np.asarray(mask, dtype=np.uint8)


def build_transforms(img_size: Tuple[int, int], augment: bool) -> PairedCompose:
    """The train/eval pipelines of reference utils/data_loader.py:109-137,
    minus the on-device steps (ToTensor scaling + Normalize)."""
    ts = [PairedResize(img_size)]
    if augment:
        ts += [PairedRandomRotation(90.0), PairedRandomHorizontalFlip()]
    ts.append(PairedToArray())
    return PairedCompose(ts)
