"""Weights in and out of the port (counterpart of dfc_sa_unet_tpu/utils/torch_convert.py).

The port's modules carry the reference's state-dict keys, so loading is
``model.load_state_dict(sd, strict=True)`` on a state dict from:

* ``from_jax_variables`` - Flax ``{'params':..,'batch_stats':..}`` (nested
  dicts of numpy arrays), by the inverse naming rule of
  torch_convert.py:179-258: a trailing ``_<digits>`` on a module name was
  a Sequential or ModuleList index (``conv_branch_0`` -> ``conv_branch.0``,
  ``layers_3`` -> ``layers.3``); HWIO kernels become OIHW, Dense kernels
  [in,out] become [out,in], ``kernel_t`` becomes IOHW, ``scale`` ->
  ``weight`` (BatchNorm, LayerNorm, GroupNorm), the packed
  ``in_proj_weight`` (E,3E) becomes (3E,E), position embeddings pass as
  they are;
* ``load_state_dict_file`` - a reference ``.pth`` (a raw state dict or a
  trainer checkpoint holding ``model_state_dict``, torch_convert.py:153-161).

``init_random_`` fills a model with seeded weights and BatchNorm
statistics for checks that need no trained checkpoint;
``calibrate_batch_stats_`` then fits the statistics to a batch.
"""

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn


def _unfold_numeric(name: str):
    """'conv_branch_0' -> ['conv_branch', '0']; 'down1' -> ['down1']."""
    tail = []
    while "_" in name:
        head, _, last = name.rpartition("_")
        if not last.isdigit():
            break
        tail.insert(0, last)
        name = head
    return [name] + tail


def _leaf(val) -> torch.Tensor:
    a = np.asarray(val)
    if np.issubdtype(a.dtype, np.floating):
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def from_jax_variables(variables: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """Flax variables -> a reference-layout state dict of f32 tensors (BatchNorm
    modules get a ``num_batches_tracked`` of 0, which strict loading requires)."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()

    def walk_params(node, prefix):
        for name, v in node.items():
            if isinstance(v, Mapping):
                walk_params(v, prefix + _unfold_numeric(name))
                continue
            a = np.asarray(v)
            key = ".".join(prefix)
            if name == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T  # HWIO -> OIHW; [in,out] -> [out,in]
                out[f"{key}.weight"] = _leaf(a)
            elif name == "kernel_t":
                out[f"{key}.weight"] = _leaf(a.transpose(2, 3, 0, 1))  # [kh,kw,I,O] -> IOHW
            elif name == "scale":
                out[f"{key}.weight"] = _leaf(a)
            elif name == "bias":
                out[f"{key}.bias"] = _leaf(a)
            else:
                # gamma, res_scale, in_proj_weight, pos_embed, ...: the forward
                # converter transposes a 2-D value only when the shapes demand
                # it, so only a non-square one is transposed back
                if a.ndim == 2 and a.shape[0] != a.shape[1]:
                    a = a.T
                out[f"{key}.{name}" if key else name] = _leaf(a)

    def walk_stats(node, prefix):
        for name, v in node.items():
            if isinstance(v, Mapping):
                walk_stats(v, prefix + _unfold_numeric(name))
                continue
            key = ".".join(prefix)
            if name == "mean":
                out[f"{key}.running_mean"] = _leaf(v)
            elif name == "var":
                out[f"{key}.running_var"] = _leaf(v)
                out[f"{key}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
            else:
                raise KeyError(f"unknown batch_stats leaf {name!r} at {key}")

    walk_params(variables.get("params", {}), [])
    walk_stats(variables.get("batch_stats", {}), [])
    return out


def load_state_dict_file(path: str) -> "OrderedDict[str, torch.Tensor]":
    """A reference ``.pth``: raw state dict or trainer checkpoint."""
    ckpt = torch.load(str(path).replace("\\", "/"), map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    return OrderedDict((k, torch.as_tensor(v)) for k, v in ckpt.items())


@torch.no_grad()
def init_random_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded weights in place, drawn on the CPU from ``generator``:
    conv and linear weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    as torch's default init, the affine parameters of BatchNorm, GroupNorm
    and LayerNorm and BatchNorm's running statistics jittered around their
    defaults, attention ``gamma`` in [0.5, 1) so the attention branch
    counts, ``res_scale`` 0.1, the packed ``in_proj_weight`` Xavier-uniform
    with a small non-zero ``in_proj_bias``, and position embeddings
    N(0, 0.5^2) (TransUNet's start at zero in the reference; a seeded check
    wants them to count)."""
    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator) * (hi - lo) + lo

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            fan_in = w.shape[1] * w[0, 0].numel() if isinstance(mod, nn.ConvTranspose2d) else w[0].numel()
            bound = 1.0 / fan_in ** 0.5
            w.copy_(uniform(w.shape, -bound, bound))
            if mod.bias is not None:
                mod.bias.copy_(uniform(mod.bias.shape, -bound, bound))
        elif isinstance(mod, (nn.BatchNorm2d, nn.GroupNorm, nn.LayerNorm)):
            mod.weight.copy_(uniform(mod.weight.shape, 0.5, 1.5))
            mod.bias.copy_(uniform(mod.bias.shape, -0.2, 0.2))
            if isinstance(mod, nn.BatchNorm2d):
                c = mod.num_features
                mod.running_mean.copy_(torch.randn((c,), generator=generator) * 0.3)
                mod.running_var.copy_(uniform((c,), 0.5, 2.0))
    for name, p in model.named_parameters():
        if name.endswith("gamma"):
            p.copy_(uniform(p.shape, 0.5, 1.0))
        elif name.endswith("res_scale"):
            p.fill_(0.1)
        elif name.endswith("in_proj_weight"):
            bound = (6.0 / (p.shape[0] + p.shape[1])) ** 0.5
            p.copy_(uniform(p.shape, -bound, bound))
        elif name.endswith("in_proj_bias"):
            p.copy_(uniform(p.shape, -0.02, 0.02))
        elif name.endswith(("pos_embed", "position_embeddings")):
            p.copy_(torch.randn(p.shape, generator=generator) * 0.5)
    return model


@torch.no_grad()
def calibrate_batch_stats_(model: nn.Module, x: torch.Tensor) -> nn.Module:
    """Set every BatchNorm's running statistics to those of one forward of
    ``x`` (normalised NCHW images) in which the BatchNorms alone are in
    training mode (dropout stays off), so seeded weights carry O(1)
    activations through the whole depth and the logits spread O(1) instead
    of collapsing toward a constant.  Returns the model in eval mode."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    momenta = [bn.momentum for bn in bns]
    model.eval()
    for bn in bns:
        bn.momentum = 1.0  # running statistics := this batch's
        bn.train()
    model(x)
    model.eval()
    for bn, momentum in zip(bns, momenta):
        bn.momentum = momentum
    return model
