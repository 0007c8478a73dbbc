from dfc_sa_unet_torch.infer.engine import DFCEngine, fold_conv_bn
from dfc_sa_unet_torch.infer.predictor import Predictor, load_image, prefetch

__all__ = ["DFCEngine", "Predictor", "fold_conv_bn", "load_image", "prefetch"]
