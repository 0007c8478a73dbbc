"""Building blocks of the DFC-SA U-Net (counterpart of dfc_sa_unet_tpu/models/blocks.py).

Module names follow the reference PyTorch state-dict keys, Sequential
indices included (``down1.conv_branch.0.weight``,
``down1.attn_branch.3.query_conv.weight``), so reference checkpoints and
``utils/weights.from_jax_variables`` exports load with ``strict=True``.

Activations are NCHW tensors stored channels_last; the attention core
takes their NHWC views.  The f32 islands of the JAX blocks are kept:
``gamma*out + x`` (blocks.py:66), the gated fusion, and the scaled
residual ``out + res_scale*res`` (blocks.py:140) are summed in f32.
"""

import torch
from torch import nn

from dfc_sa_unet_torch.nn.layers import BatchNorm, Conv
from dfc_sa_unet_torch.ops.pooled_attention import pooled_attention
from dfc_sa_unet_torch.ops.pooling import adaptive_avg_pool, max_pool
from dfc_sa_unet_torch.ops.resize import resize_bilinear


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC (a free view for channels_last storage)."""
    return t.permute(0, 2, 3, 1).contiguous()


def nchw(t: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view with channels_last strides."""
    return t.permute(0, 3, 1, 2)


class LightSelfAttention(nn.Module):
    """Pooled global self-attention (reference models/unet_dfc_sa_res.py:5-39):
    avg-pool to (p,p) -> 1x1 Q/K at C//qk_div, V at C -> softmax(QK^T) V
    (unscaled) -> bilinear upsample -> gamma*out + x.

    The attention core always goes through ops/pooled_attention.py: the
    CUDA kernel on the card (which raises for what it does not take, such
    as N = p*p > 1024), the plain version on CPU tensors.
    """

    def __init__(self, channels, pool_size=8, qk_div=8, compute_dtype=None):
        super().__init__()
        self.pool_size = pool_size
        self.query_conv = Conv(channels, channels // qk_div, 1, compute_dtype=compute_dtype)
        self.key_conv = Conv(channels, channels // qk_div, 1, compute_dtype=compute_dtype)
        self.value_conv = Conv(channels, channels, 1, compute_dtype=compute_dtype)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x):
        h, w = x.shape[2:]
        p = self.pool_size
        pooled = adaptive_avg_pool(x, (p, p))
        q, k, v = (nhwc(conv(pooled)) for conv in (self.query_conv, self.key_conv, self.value_conv))
        out = resize_bilinear(nchw(pooled_attention(q, k, v)), (h, w))
        return (self.gamma * out.float() + x.float()).to(x.dtype)


def conv_bn_relu(cin, cout, kernel, compute_dtype):
    """conv(k) + BN + ReLU as the reference's nn.Sequential (indices 0, 1, 2)."""
    return nn.Sequential(Conv(cin, cout, kernel, padding=kernel // 2, compute_dtype=compute_dtype),
                         BatchNorm(cout), nn.ReLU())


class DFCBlock(nn.Module):
    """DynamicFusionConvAttnBlock (reference models/unet_dfc_sa_res.py:41-116).

    local  = Conv3x3+BN+ReLU
    attn   = Conv1x1+BN+ReLU -> LightSelfAttention
    g      = sigmoid(BN(Conv1x1(cat(local, attn))))
    fused  = g*local + (1-g)*attn
    out    = Conv1x1+BN+ReLU(cat(fused, local, attn)) + res_scale*proj(x)

    proj is a bias-free 1x1 conv when the channel counts differ and the
    identity otherwise (no ``residual_conv`` keys, as in the reference).
    """

    def __init__(self, cin, features, pool_size=8, qk_div=8, compute_dtype=None):
        super().__init__()
        f = features
        self.conv_branch = conv_bn_relu(cin, f, 3, compute_dtype)
        self.attn_branch = conv_bn_relu(cin, f, 1, compute_dtype)
        self.attn_branch.append(LightSelfAttention(f, pool_size, qk_div, compute_dtype))
        self.gate = nn.Sequential(Conv(2 * f, f, 1, compute_dtype=compute_dtype), BatchNorm(f), nn.Sigmoid())
        self.fusion_conv = conv_bn_relu(3 * f, f, 1, compute_dtype)
        self.residual_conv = (Conv(cin, f, 1, bias=False, compute_dtype=compute_dtype)
                              if cin != f else None)
        self.res_scale = nn.Parameter(torch.tensor(0.1))

    def forward(self, x):
        local = self.conv_branch(x)
        a = self.attn_branch(x)
        g = self.gate(torch.cat([local, a], 1)).float()
        fused = (g * local.float() + (1.0 - g) * a.float()).to(local.dtype)
        out = self.fusion_conv(torch.cat([fused, local, a], 1))
        res = x if self.residual_conv is None else self.residual_conv(x)
        return (out.float() + self.res_scale * res.float()).to(out.dtype)


def unet_forward(model: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """The 4-level U-Net wiring (reference models/unet_dfc_sa_res.py:161-204):
    encoder blocks + MaxPool(2), bottleneck, ConvTranspose(2,2) decoder with a
    bilinear shape fix and the skip concat, final 1x1 conv.  ``model`` holds
    down1..4, bottleneck, up1..4, up_conv1..4 and final_conv."""
    skips = []
    h = x
    for i in range(1, 5):
        h = getattr(model, f"down{i}")(h)
        skips.append(h)
        h = max_pool(h, 2, 2)
    h = model.bottleneck(h)
    for i in range(4, 0, -1):
        skip = skips[i - 1]
        h = getattr(model, f"up{i}")(h)
        if h.shape[2:] != skip.shape[2:]:
            h = resize_bilinear(h, skip.shape[2:])
        h = getattr(model, f"up_conv{i}")(torch.cat([h, skip], 1))
    return model.final_conv(h)


__all__ = ["DFCBlock", "LightSelfAttention", "conv_bn_relu", "nchw",
           "nhwc", "unet_forward"]
