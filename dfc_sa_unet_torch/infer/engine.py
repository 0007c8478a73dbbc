"""Serving engine for the DFC-SA U-Net (counterpart of dfc_sa_unet_tpu/infer/engine.py).

Numerically the module's eval forward, built for serving:

* every Conv+BatchNorm pair is folded into one conv (eval-mode BN is a
  per-channel affine: W' = W*a, b' = (b - mean)*a + beta);
* activations stay in the compute dtype end to end;
* the attention core always goes through ``ops/pooled_attention`` (the
  CUDA kernel on the card);
* ``tail_kernel_levels`` picks the blocks whose whole tail (3x3 conv,
  gate, fusion, residual) runs as one CUDA kernel (``ops/dfc_tail``), as
  ``pallas_conv_levels`` did; ``"auto"`` is the same 7 levels;
* ``conv_kernel_levels`` picks the blocks whose local branch runs the
  same kernel's 3x3 conv mainloop on its own (``conv3x3_bn_relu``);
  ``"auto"`` is the two blocks outside the "auto" tail set (down1, whose
  Cin = 3, and the bottleneck, whose C = 1024 is beyond the tail kernel).

Both take ``None``, a set of block names or ``"auto"``, and must not
overlap.  A block in neither set runs on cuDNN convs and torch ops.

Takes normalised NCHW activations (channels_last) like the module and
returns NCHW logits in the compute dtype.
"""

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from dfc_sa_unet_torch.models.blocks import nchw, nhwc
from dfc_sa_unet_torch.ops.convt import conv_transpose_2x2
from dfc_sa_unet_torch.ops.dfc_tail import conv3x3_bn_relu, dfc_tail
from dfc_sa_unet_torch.ops.pooled_attention import pooled_attention
from dfc_sa_unet_torch.ops.pooling import adaptive_avg_pool, max_pool
from dfc_sa_unet_torch.ops.resize import resize_bilinear
from dfc_sa_unet_torch.utils.device import resolve_device

BLOCKS = ("down1", "down2", "down3", "down4", "bottleneck",
          "up_conv4", "up_conv3", "up_conv2", "up_conv1")
AUTO_TAIL_LEVELS = frozenset({"down2", "down3", "down4", "up_conv4", "up_conv3", "up_conv2", "up_conv1"})
AUTO_CONV_LEVELS = frozenset(BLOCKS) - AUTO_TAIL_LEVELS


def fold_conv_bn(weight, bias, bn_weight, bn_bias, mean, var, eps: float = 1e-5):
    """Fold eval-mode BatchNorm into the preceding conv: OIHW weight, bias."""
    a = bn_weight / torch.sqrt(var + eps)
    w = weight * a.view(-1, *([1] * (weight.dim() - 1)))
    b = ((bias if bias is not None else 0.0) - mean) * a + bn_bias
    return w, b


def _levels(levels, auto):
    if levels == "auto":
        return set(auto)
    levels = set(levels or ())
    unknown = levels - set(BLOCKS)
    if unknown:
        raise ValueError(f"unknown block names {sorted(unknown)}; blocks are {BLOCKS}")
    return levels


def _conv(x, weight, bias, padding=0):
    """Folded conv: emitted in x's dtype, f32 bias added before the cast."""
    return (F.conv2d(x, weight, padding=padding) + bias.view(-1, 1, 1)).to(x.dtype)


class DFCEngine:
    """Folded inference for UNetDFCSA(Res).  ``weights`` is a state dict with
    the reference keys (or a module holding one)."""

    def __init__(self, config: Mapping[str, Any], weights, dtype=torch.bfloat16, device=None,
                 tail_kernel_levels=None, conv_kernel_levels=None):
        m = config.get("model", config)
        if m["name"] != "DFC-SA-Res-Block":
            raise NotImplementedError(f"DFCEngine serves DFC-SA-Res-Block, not {m['name']!r}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.pool_size = m.get("pool_size", 8)
        self.tail_kernel_levels = _levels(tail_kernel_levels, AUTO_TAIL_LEVELS)
        self.conv_kernel_levels = _levels(conv_kernel_levels, AUTO_CONV_LEVELS)
        both = self.tail_kernel_levels & self.conv_kernel_levels
        if both:
            raise ValueError(f"blocks {sorted(both)} are in both tail_kernel_levels and conv_kernel_levels")
        if isinstance(weights, nn.Module):
            weights = weights.state_dict()
        sd = {k: v.detach().to(self.device, torch.float32) for k, v in weights.items()
              if not k.endswith("num_batches_tracked")}
        self.blocks = {name: self._fold_block(sd, name) for name in BLOCKS}
        self.ups = {f"up{i}": (sd[f"up{i}.weight"].to(dtype), sd[f"up{i}.bias"]) for i in range(1, 5)}
        self.final = (sd["final_conv.weight"].to(dtype), sd["final_conv.bias"])

    # ------------------------------------------------------------- folding

    def _fold_block(self, sd, name):
        def p(key):
            return sd[f"{name}.{key}"]

        def fold(conv, bn):
            return fold_conv_bn(p(f"{conv}.weight"), p(f"{conv}.bias"), p(f"{bn}.weight"),
                                p(f"{bn}.bias"), p(f"{bn}.running_mean"), p(f"{bn}.running_var"))

        dt = self.dtype
        kc, bc = fold("conv_branch.0", "conv_branch.1")
        ka, ba = fold("attn_branch.0", "attn_branch.1")
        kg, bg = fold("gate.0", "gate.1")
        kf, bf = fold("fusion_conv.0", "fusion_conv.1")
        c = kc.shape[0]
        res_scale = p("res_scale")
        d = {
            "conv": (kc.to(dt), bc), "attn0": (ka.to(dt), ba), "kg": (kg.to(dt), bg),
            "kf": (kf.to(dt), bf),
            # the kernels' layout: HWIO 3x3 weight, [K, C] 1x1 weights
            "wc": kc.permute(2, 3, 1, 0).contiguous().to(dt),
            "wg": kg[:, :, 0, 0].t().contiguous().to(dt),
            "wf": kf[:, :, 0, 0].t().contiguous().to(dt),
        }
        if f"{name}.residual_conv.weight" in sd:
            kr = p("residual_conv.weight") * res_scale
            d["kr"] = kr.to(dt)
            d["wr"] = kr[:, :, 0, 0].t().contiguous().to(dt)
        else:  # identity residual (Cin == C): eye * res_scale
            d["kr"] = None
            d["res_scale"] = res_scale
            d["wr"] = (torch.eye(c, device=self.device) * res_scale).to(dt)
        lsa = "attn_branch.3"
        d["lsa"] = {
            key: (p(f"{lsa}.{key}_conv.weight").to(dt), p(f"{lsa}.{key}_conv.bias"))
            for key in ("query", "key", "value")
        }
        d["lsa"]["gamma"] = p(f"{lsa}.gamma")
        return d

    # ------------------------------------------------------------- forward

    def _lsa(self, d, a):
        h, w = a.shape[2:]
        p = self.pool_size
        pooled = adaptive_avg_pool(a, (p, p))
        q, k, v = (nhwc(_conv(pooled, *d[key])) for key in ("query", "key", "value"))
        o = resize_bilinear(nchw(pooled_attention(q, k, v)), (h, w))
        return (d["gamma"] * o.float() + a.float()).to(a.dtype)

    def _tail_lax(self, d, local, a, x):
        """The module tail with BN folded: concat + 1x1 convs."""
        combined = torch.cat([local, a], 1)
        g = torch.sigmoid(_conv(combined, *d["kg"]).float())
        fused = (g * local.float() + (1.0 - g) * a.float()).to(local.dtype)
        o = torch.relu(_conv(torch.cat([fused, combined], 1), *d["kf"]).float())
        if d["kr"] is not None:
            o = o + F.conv2d(x, d["kr"])
        else:
            o = o + d["res_scale"] * x.float()
        return o.to(local.dtype)

    def _attn_branch(self, d, x):
        a = torch.relu(_conv(x, *d["attn0"]).float()).to(x.dtype)
        return self._lsa(d["lsa"], a)

    def _block(self, name, x):
        d = self.blocks[name]
        if name in self.tail_kernel_levels:
            a = self._attn_branch(d, x)
            out = dfc_tail(nhwc(x), nhwc(a), d["wc"], d["conv"][1], d["wg"], d["kg"][1],
                           d["wf"], d["kf"][1], d["wr"])
            return nchw(out)
        if name in self.conv_kernel_levels:
            local = nchw(conv3x3_bn_relu(nhwc(x), d["wc"], d["conv"][1]))
        else:
            # bias-free 3x3 conv in the compute dtype, then the +bc/ReLU epilogue
            y3 = F.conv2d(x, d["conv"][0], padding=1).to(x.dtype)
            local = torch.relu(y3.float() + d["conv"][1].view(-1, 1, 1)).to(x.dtype)
        a = self._attn_branch(d, x)
        return self._tail_lax(d, local, a, x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device, self.dtype, memory_format=torch.channels_last)
        skips = []
        h = x
        for i in range(1, 5):
            h = self._block(f"down{i}", h)
            skips.append(h)
            h = max_pool(h, 2, 2)
        h = self._block("bottleneck", h)
        for i in range(4, 0, -1):
            skip = skips[i - 1]
            h = conv_transpose_2x2(h, *self.ups[f"up{i}"])
            if h.shape[2:] != skip.shape[2:]:
                h = resize_bilinear(h, skip.shape[2:])
            h = self._block(f"up_conv{i}", torch.cat([h, skip], 1))
        return _conv(h, *self.final)

    __call__ = forward
