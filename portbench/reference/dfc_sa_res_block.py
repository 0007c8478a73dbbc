"""Plain float32 reference of the DFC-SA-Res-Block U-Net (the DFC-SA-U-Net reference repository,
models/unet_dfc_sa_res.py), written over a state dict with that repository's keys.

A block (``DynamicFusionConvAttnBlock``):

    local = ReLU(BN(Conv3x3(x)))
    a0    = ReLU(BN(Conv1x1(x)))
    a     = gamma * up(softmax(q k^T) v) + a0    q, k, v 1x1 convs of AvgPool_p(a0); q, k at C // 8;
                                                 the energies unscaled; up bilinear, align_corners off
    g     = sigmoid(BN(Conv1x1([local, a])))
    fused = g * local + (1 - g) * a
    out   = ReLU(BN(Conv1x1([fused, local, a]))) + res_scale * R(x)   R a bias-free 1x1 conv, or the
                                                                      identity where Cin == C

The U-Net: four encoder blocks with 2x2 max pools between them, a bottleneck at twice the last
width, four decoder levels of a 2x2 transposed conv (bilinear resize to the skip where the sizes
differ), the skip concatenated after it and a block, and a final 1x1 conv.

Serving is the module in eval mode (running statistics); training is the module in train mode
(batch statistics), each block recomputed in the backward when ``checkpoint`` is set, so that a
float32 step at the timed batch fits on one card.  BatchNorm's moved running statistics come back
from ``Norms.moved``.
"""

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

from portbench.reference.plain import Norms, Precision

BLOCKS = ("down1", "down2", "down3", "down4", "bottleneck", "up_conv4", "up_conv3", "up_conv2", "up_conv1")


def _widths(m):
    """{block: (cin, features)} and {up_i: (cin, cout)} of the model section ``m``."""
    f = list(m.get("features", [64, 128, 256, 512]))
    cin = m.get("in_channels", 3)
    blocks = {}
    for i, c in enumerate([cin] + f[:3]):
        blocks[f"down{i + 1}"] = (c, f[i])
    blocks["bottleneck"] = (f[3], 2 * f[3])
    ups = {}
    for i, c in zip(range(4, 0, -1), [2 * f[3]] + f[3:0:-1]):
        ups[f"up{i}"] = (c, f[i - 1])
        blocks[f"up_conv{i}"] = (2 * f[i - 1], f[i - 1])
    return blocks, ups


def state_spec(config) -> dict:
    """{key: (shape, draw)} of the configuration's model: every parameter and BatchNorm statistic.
    ``draw`` is ("normal", mean, std) or ("lognormal", median, sigma).  Convolutions take a
    variance-preserving spread (2 / fan-in before a ReLU), biases and BatchNorm shifts a small
    one; the running statistics are drawn so that BatchNorm's folding has real work; gamma and
    res_scale make the attention branch and the residual count."""
    m = config["model"]
    qk_div = m.get("ablation_on_qk_channels", 8)
    spec = {}

    def conv(key, cout, cin, k, bias=True, gain=2.0):
        spec[f"{key}.weight"] = ((cout, cin, k, k), ("normal", 0.0, (gain / (cin * k * k)) ** 0.5))
        if bias:
            spec[f"{key}.bias"] = ((cout,), ("normal", 0.0, 0.05))

    def bn(key, c):
        spec[f"{key}.weight"] = ((c,), ("normal", 1.0, 0.1))
        spec[f"{key}.bias"] = ((c,), ("normal", 0.0, 0.1))
        spec[f"{key}.running_mean"] = ((c,), ("normal", 0.0, 0.2))
        spec[f"{key}.running_var"] = ((c,), ("lognormal", 1.0, 0.3))

    blocks, ups = _widths(m)
    for name, (cin, f) in blocks.items():
        conv(f"{name}.conv_branch.0", f, cin, 3)
        bn(f"{name}.conv_branch.1", f)
        conv(f"{name}.attn_branch.0", f, cin, 1)
        bn(f"{name}.attn_branch.1", f)
        lsa = f"{name}.attn_branch.3"
        conv(f"{lsa}.query_conv", f // qk_div, f, 1, gain=1.0)
        conv(f"{lsa}.key_conv", f // qk_div, f, 1, gain=1.0)
        conv(f"{lsa}.value_conv", f, f, 1, gain=1.0)
        spec[f"{lsa}.gamma"] = ((1,), ("normal", 0.75, 0.1))
        conv(f"{name}.gate.0", f, 2 * f, 1, gain=1.0)
        bn(f"{name}.gate.1", f)
        conv(f"{name}.fusion_conv.0", f, 3 * f, 1)
        bn(f"{name}.fusion_conv.1", f)
        if cin != f:
            conv(f"{name}.residual_conv", f, cin, 1, bias=False, gain=1.0)
        spec[f"{name}.res_scale"] = ((), ("normal", 0.1, 0.01))
    for name, (cin, cout) in ups.items():
        # ConvTranspose2d's weight is [Cin, Cout, 2, 2]; at stride 2 each output reads one tap of each input channel
        spec[f"{name}.weight"] = ((cin, cout, 2, 2), ("normal", 0.0, (1.0 / cin) ** 0.5))
        spec[f"{name}.bias"] = ((cout,), ("normal", 0.0, 0.05))
    f0 = list(m.get("features", [64]))[0]
    conv("final_conv", m.get("out_channels", 1), f0, 1, gain=1.0)
    return spec


class Model:
    """The forward over the state dict ``sd`` (float32 tensors, which may require grad)."""

    def __init__(self, config, sd, train=False, precision=None, checkpoint=False):
        m = config["model"]
        self.sd, self.p = sd, Precision(precision)
        self.pool = m.get("pool_size", 8)
        self.norms = Norms(sd, train)
        self.checkpoint = checkpoint

    def _conv(self, x, key, padding=0, bias=True):
        return self.p.conv(x, self.sd[f"{key}.weight"], self.sd[f"{key}.bias"] if bias else None, padding=padding)

    def _lsa(self, a0, key):
        b, c, h, w = a0.shape
        pooled = F.adaptive_avg_pool2d(a0, (self.pool, self.pool))
        q, k, v = (self._conv(pooled, f"{key}.{n}_conv").flatten(2) for n in ("query", "key", "value"))
        energy = self.p.matmul(q.transpose(1, 2), k)  # [B, N, N], unscaled
        attn = torch.softmax(energy, dim=-1)
        o = self.p.matmul(v, attn.transpose(1, 2)).view(b, c, self.pool, self.pool)
        o = F.interpolate(o, size=(h, w), mode="bilinear", align_corners=False)
        return self.sd[f"{key}.gamma"] * o + a0

    def block(self, name, x):
        bn = self.norms
        local = F.relu(bn(self._conv(x, f"{name}.conv_branch.0", padding=1), f"{name}.conv_branch.1"))
        a0 = F.relu(bn(self._conv(x, f"{name}.attn_branch.0"), f"{name}.attn_branch.1"))
        a = self._lsa(a0, f"{name}.attn_branch.3")
        g = torch.sigmoid(bn(self._conv(torch.cat([local, a], 1), f"{name}.gate.0"), f"{name}.gate.1"))
        fused = g * local + (1.0 - g) * a
        out = F.relu(bn(self._conv(torch.cat([fused, local, a], 1), f"{name}.fusion_conv.0"), f"{name}.fusion_conv.1"))
        key = f"{name}.residual_conv.weight"
        res = self.p.conv(x, self.sd[key]) if key in self.sd else x
        return out + self.sd[f"{name}.res_scale"] * res

    def _run(self, name, x):
        if self.checkpoint and torch.is_grad_enabled():
            return _checkpoint(self.block, name, x, use_reentrant=False)
        return self.block(name, x)

    def __call__(self, x):
        """Normalised float32 NCHW images -> logits [B, out_channels, H, W]."""
        skips, h = [], x
        for i in range(1, 5):
            h = self._run(f"down{i}", h)
            skips.append(h)
            h = F.max_pool2d(h, 2, 2)
        h = self._run("bottleneck", h)
        for i in range(4, 0, -1):
            skip = skips[i - 1]
            h = self.p.conv_transpose(h, self.sd[f"up{i}.weight"], self.sd[f"up{i}.bias"], 2)
            if h.shape[2:] != skip.shape[2:]:
                h = F.interpolate(h, size=skip.shape[2:], mode="bilinear", align_corners=False)
            h = self._run(f"up_conv{i}", torch.cat([h, skip], 1))
        return self._conv(h, "final_conv")
