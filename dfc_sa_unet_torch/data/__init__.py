from dfc_sa_unet_torch.data.dataset import SegmentationDataset
from dfc_sa_unet_torch.data.loader import DataLoaderFactory
from dfc_sa_unet_torch.data.normalize import normalize

__all__ = ["DataLoaderFactory", "SegmentationDataset", "normalize"]
