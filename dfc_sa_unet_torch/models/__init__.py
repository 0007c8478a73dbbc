from dfc_sa_unet_torch.models.blocks import (
    AdditionFusionBlock,
    AttentionOnlyBlock,
    ConcatFusionBlock,
    DFCBlock,
    LightSelfAttention,
    LocalOnlyBlock,
)
from dfc_sa_unet_torch.models.dfc_sa import UNetDFCSA, UNetDFCSARes
from dfc_sa_unet_torch.models.factory import ModelFactory, create_model
from dfc_sa_unet_torch.models.sam import SAM
from dfc_sa_unet_torch.models.segformer import SegFormer
from dfc_sa_unet_torch.models.transunet import TransUNet
from dfc_sa_unet_torch.models.unet import UNet
from dfc_sa_unet_torch.models.vit_seg import VisionTransformerForSegmentation

__all__ = ["AdditionFusionBlock", "AttentionOnlyBlock", "ConcatFusionBlock", "DFCBlock", "LightSelfAttention",
           "LocalOnlyBlock", "ModelFactory", "SAM", "SegFormer", "TransUNet", "UNet", "UNetDFCSA", "UNetDFCSARes",
           "VisionTransformerForSegmentation", "create_model"]
