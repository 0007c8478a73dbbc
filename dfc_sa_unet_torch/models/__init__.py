from dfc_sa_unet_torch.models.dfc_sa import UNetDFCSA, UNetDFCSARes
from dfc_sa_unet_torch.models.factory import create_model

__all__ = ["UNetDFCSA", "UNetDFCSARes", "create_model"]
