"""create_model (counterpart of dfc_sa_unet_tpu/models/factory.py:24).

Ported so far: the flagship ``DFC-SA-Res-Block`` and the transformer zoo,
``VisionTransformerSegmentation`` and ``TransformerUNet`` / ``TransUNet``,
with the JAX factory's config keys and defaults.  The other nine names of
the JAX factory raise NotImplementedError (see ROADMAP.md Queue A).
"""

import math
from typing import Any, Mapping

import torch
from torch import nn

from dfc_sa_unet_torch.utils.device import resolve_device

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
    any of them as "every encoder layer, ResNet unit and decoder block"."""
    dev = resolve_device(device)
    m = _model_cfg(config)
    name = m["name"]
    for flag in (use_pallas, m.get("use_pallas", False)):
        if not isinstance(flag, bool):
            raise TypeError(f"use_pallas must be true or false, not {flag!r}")
    remat = remat or m.get("remat", False)
    in_channels = m.get("in_channels", 3)
    out_channels = m.get("out_channels", 1)
    if name == "DFC-SA-Res-Block":
        from dfc_sa_unet_torch.models.dfc_sa import UNetDFCSARes

        model = UNetDFCSARes(
            in_channels=in_channels,
            out_channels=out_channels,
            features=tuple(m.get("features", [64, 128, 256, 512])),
            pool_size=m.get("pool_size", 8),
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
        raise NotImplementedError(
            f"model {name!r} is not ported to dfc_sa_unet_torch yet (see ROADMAP.md, Queue A)")
    return model.to(dev, memory_format=torch.channels_last)
