"""create_model (counterpart of dfc_sa_unet_tpu/models/factory.py:24).

Only the flagship ``DFC-SA-Res-Block`` is ported so far; every other name
of the JAX factory raises NotImplementedError (see ROADMAP.md Queue A).
"""

from typing import Any, Mapping

import torch
from torch import nn

from dfc_sa_unet_torch.utils.device import resolve_device


def _model_cfg(config: Mapping[str, Any]) -> Mapping[str, Any]:
    return config.get("model", config)


def create_model(config: Mapping[str, Any], dtype=None, use_pallas: bool = False, device=None) -> nn.Module:
    """The module named by ``config['model']['name']``, on ``device`` (default
    CUDA, raising without it) in channels_last storage.

    The port's attention core always runs the CUDA kernel on the card (and
    its plain version on CPU tensors), so ``model.use_pallas`` in the
    config, and ``use_pallas``, are only checked to be booleans: neither
    value sends CUDA tensors to a plain version."""
    dev = resolve_device(device)
    m = _model_cfg(config)
    name = m["name"]
    for flag in (use_pallas, m.get("use_pallas", False)):
        if not isinstance(flag, bool):
            raise TypeError(f"use_pallas must be true or false, not {flag!r}")
    if name != "DFC-SA-Res-Block":
        raise NotImplementedError(
            f"model {name!r} is not ported to dfc_sa_unet_torch yet (see ROADMAP.md, Queue A)")
    from dfc_sa_unet_torch.models.dfc_sa import UNetDFCSARes

    model = UNetDFCSARes(
        in_channels=m.get("in_channels", 3),
        out_channels=m.get("out_channels", 1),
        features=tuple(m.get("features", [64, 128, 256, 512])),
        pool_size=m.get("pool_size", 8),
        qk_div=m.get("ablation_on_qk_channels", 8),
        compute_dtype=dtype,
    )
    return model.to(dev, memory_format=torch.channels_last)
