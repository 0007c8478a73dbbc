from dfc_sa_unet_torch.models.dfc_sa import UNetDFCSA, UNetDFCSARes
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.models.transunet import TransUNet
from dfc_sa_unet_torch.models.vit_seg import VisionTransformerForSegmentation

__all__ = ["TransUNet", "UNetDFCSA", "UNetDFCSARes", "VisionTransformerForSegmentation", "create_model"]
