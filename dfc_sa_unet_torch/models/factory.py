"""create_model and the weight-loading facade (counterpart of
dfc_sa_unet_tpu/models/factory.py: ``create_model``, ``load_variables``,
``load_pretrained_variables``, ``get_model_and_variables`` and
``ModelFactory``; ``read_variables`` reads a weights file without a model).

All twelve names of the JAX factory, with its config keys and defaults:
the flagship ``DFC-SA-Res-Block``, the vanilla ``UNet``, the eight
ablations (``UNet_Baseline``, ``UNet_AttentionOnly``,
``UNet_AdditionFusion``, ``UNet_ConcatFusion``, ``UNet_FullResAttention``,
``UNet_EncoderOnlyDFC``, ``UNet_DecoderOnlyDFC``,
``UNet_BothStandardConv``) and the transformer zoo,
``VisionTransformerSegmentation`` and ``TransformerUNet`` / ``TransUNet``;
and one the JAX package lacks, ``SegFormer`` (models/segformer.py:
``embed_dims``, ``depths``, ``num_heads``, ``sr_ratios``, ``mlp_ratio`` and
``decoder_dim``, MiT-B5's by default) and ``SAM`` (models/sam.py: Segment Anything's
image encoder, box prompt encoder and mask decoder, the keys of ``sam.VIT_B``, ViT-B's by
default, one output mask).  Any other name raises ValueError.

In JAX a module holds no weights, so the facade returns Flax variables beside
the model.  A PyTorch module holds its own: here "variables" are the state
dict already loaded into the model, and returning it keeps JAX's call shapes.
"""

import math
import os
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from dfc_sa_unet_torch.utils.device import resolve_device
from dfc_sa_unet_torch.utils.weights import load_state_dict_file


def _model_cfg(config: Mapping[str, Any]) -> Mapping[str, Any]:
    return config.get("model", config)


def create_model(config: Mapping[str, Any], dtype=None, use_pallas: bool = False, device=None,
                 remat=False) -> nn.Module:
    """The module named by ``config['model']['name']``, on ``device`` (default
    CUDA, raising without it) in channels_last storage.

    The port's attention cores always run their CUDA kernels on the card
    (and their plain versions on CPU tensors), so ``model.use_pallas`` in
    the config, and ``use_pallas``, are only checked to be booleans:
    neither value sends CUDA tensors to a plain version.

    ``remat`` (or ``model.remat`` in the config) recomputes activations in
    the backward pass: False, 'all', 'l12' or 'deep' for the flagship (the
    block sets of ``models.blocks.REMAT_BLOCKS``); the transformers take
    any of them as "every encoder layer, ResNet unit and decoder block".
    As in the JAX factory (factory.py:37-45,113-121) it does not reach
    ``UNet`` or the ablations: they keep every activation whatever it says.
    SegFormer takes it as "every block of the encoder".
    The ablations also ignore ``ablation_on_qk_channels``: their attention
    reduces Q and K to C//8.

    ``UNet_FullResAttention`` attends over all H*W pixels of its input, so
    it takes images up to 64x64 (N = 4096) on the card; at a larger size
    the attention wrapper raises with the N it was given."""
    dev = resolve_device(device)
    m = _model_cfg(config)
    name = m["name"]
    for flag in (use_pallas, m.get("use_pallas", False)):
        if not isinstance(flag, bool):
            raise TypeError(f"use_pallas must be true or false, not {flag!r}")
    remat = remat or m.get("remat", False)
    in_channels = m.get("in_channels", 3)
    out_channels = m.get("out_channels", 1)
    features = tuple(m.get("features", [64, 128, 256, 512]))
    pool_size = m.get("pool_size", 8)
    from dfc_sa_unet_torch.models.ablations import ABLATIONS

    if name == "UNet":
        from dfc_sa_unet_torch.models.unet import UNet

        model = UNet(in_channels=in_channels, out_channels=out_channels, bilinear=m.get("bilinear", False),
                     compute_dtype=dtype)
    elif name in ABLATIONS:
        model = ABLATIONS[name](in_channels=in_channels, out_channels=out_channels, features=features,
                                pool_size=pool_size, compute_dtype=dtype)
    elif name == "DFC-SA-Res-Block":
        from dfc_sa_unet_torch.models.dfc_sa import UNetDFCSARes

        model = UNetDFCSARes(
            in_channels=in_channels,
            out_channels=out_channels,
            features=features,
            pool_size=pool_size,
            qk_div=m.get("ablation_on_qk_channels", 8),
            compute_dtype=dtype,
            remat=remat,
        )
    elif name in ("TransformerUNet", "TransUNet"):
        from dfc_sa_unet_torch.models.transunet import TransUNet, get_r50_b16_config

        img_size_cfg = config.get("dataset", {}).get("img_size", [224, 224])
        img_size = img_size_cfg[0] if isinstance(img_size_cfg, (list, tuple)) else img_size_cfg
        vit_config = get_r50_b16_config()
        vit_config["n_classes"] = out_channels
        vit_config["patches_grid"] = (img_size // 16, img_size // 16)
        model = TransUNet(config=vit_config, img_size=img_size, num_classes=out_channels, compute_dtype=dtype,
                          remat=bool(remat))
    elif name == "SegFormer":
        from dfc_sa_unet_torch.models.segformer import B5, SegFormer

        model = SegFormer(in_channels=in_channels, num_classes=out_channels,
                          **{key: m.get(key, default) for key, default in B5.items()}, compute_dtype=dtype,
                          remat=bool(remat))
    elif name == "SAM":
        from dfc_sa_unet_torch.models.sam import SAM, VIT_B

        if out_channels != 1:
            raise ValueError(f"SAM serves one mask a box prompt: out_channels must be 1, not {out_channels}")
        model = SAM(in_channels=in_channels, **{key: m.get(key, default) for key, default in VIT_B.items()},
                    compute_dtype=dtype)
    elif name == "VisionTransformerSegmentation":
        from dfc_sa_unet_torch.models.vit_seg import VisionTransformerForSegmentation

        patch_dim = m.get("patch_dim", 16)
        default_layers = int(math.log2(patch_dim)) if patch_dim > 0 and (patch_dim & (patch_dim - 1) == 0) else 4
        model = VisionTransformerForSegmentation(
            img_dim=m.get("img_dim", 224),
            patch_dim=patch_dim,
            in_channels=in_channels,
            num_classes=out_channels,
            embed_dim=m.get("embed_dim", 768),
            num_layers=m.get("num_layers", 12),
            num_heads=m.get("num_heads", 12),
            mlp_dim=m.get("mlp_dim", 3072),
            dropout=m.get("dropout", 0.1),
            upsample_layers=m.get("segmentation_head_upsample_layers", default_layers),
            compute_dtype=dtype,
            remat=bool(remat),
        )
    else:
        raise ValueError(f"unsupported model name: {name!r}")
    return model.to(dev, memory_format=torch.channels_last)


def read_variables(path) -> Mapping[str, torch.Tensor]:
    """The state dict in the ``torch.save`` file at ``path``, read without a model (the serving
    engines fold or quantize it themselves): a reference ``.pth`` (a raw state dict, or a trainer
    checkpoint holding ``model_state_dict``), or the ``best_model`` or a checkpoint
    (``checkpoint_epoch_<N>``, ``best_checkpoint``: weights under ``model``) that the port's Trainer
    wrote.  Backslashes in ``path`` become slashes, as in JAX.  A directory (an Orbax checkpoint of
    the JAX package) raises IsADirectoryError with the command that converts it."""
    path = str(path).replace("\\", "/")
    if os.path.isdir(path):
        raise IsADirectoryError(
            f"{path}: the port loads torch.save files only (a reference .pth, or the best_model or a "
            f"checkpoint of dfc_sa_unet_torch.train), not an Orbax directory: convert it first, on a machine "
            f"with JAX, with python scripts/convert_checkpoint.py --config CFG --ckpt DIR --out W.pth --to_torch")
    return load_state_dict_file(path)


def load_variables(model: nn.Module, path) -> Mapping[str, torch.Tensor]:
    """Load the weights of the file at ``path`` (any that ``read_variables`` reads) into ``model``,
    strictly, and return its state dict.

    Strict loading takes the place of JAX's conversion against a template: a wrong model name or
    width raises, naming the missing and unexpected keys.  JAX's ``img_size`` and ``in_channels``
    only shape the Flax template's dummy input; the module here is its own template, so neither is
    taken."""
    model.load_state_dict(read_variables(path), strict=True)
    return model.state_dict()


def load_pretrained_variables(model: nn.Module, config: Mapping[str, Any]):
    """``load_variables(model, config['model']['pretrained_path'])``, or None (the model untouched)
    when the config sets no path."""
    path = _model_cfg(config).get("pretrained_path")
    if not path:
        return None
    return load_variables(model, path)


def get_model_and_variables(config: Mapping[str, Any], dtype=None, use_pallas: bool = False, remat=False,
                            device=None) -> Tuple[nn.Module, Optional[Mapping[str, torch.Tensor]]]:
    """(model on ``device``, its state dict loaded from ``pretrained_path`` or None when the config
    sets none).  ``device`` defaults to CUDA and raises without it, as ``create_model`` does."""
    model = create_model(config, dtype=dtype, use_pallas=use_pallas, device=device, remat=remat)
    return model, load_pretrained_variables(model, config)


class ModelFactory:
    """The JAX package's facade over ``create_model``, in its three call styles:
    ``ModelFactory(config).create_model()``, ``ModelFactory.get_model(config)`` and
    ``ModelFactory.get_model_and_variables(config)`` (which also loads
    ``config['model']['pretrained_path']``).  Each takes ``device`` (default CUDA)."""

    def __init__(self, config: Optional[Mapping[str, Any]] = None):
        self.config = config

    def create_model(self, config=None, dtype=None, use_pallas=False, remat=False, device=None):
        cfg = config or self.config
        if cfg is None:
            raise ValueError("a config must be provided")
        return create_model(cfg, dtype=dtype, use_pallas=use_pallas, device=device, remat=remat)

    @staticmethod
    def get_model(config, dtype=None, use_pallas=False, remat=False, device=None):
        return create_model(config, dtype=dtype, use_pallas=use_pallas, device=device, remat=remat)

    @staticmethod
    def get_model_and_variables(config, dtype=None, use_pallas=False, remat=False, device=None):
        return get_model_and_variables(config, dtype=dtype, use_pallas=use_pallas, remat=remat, device=device)
