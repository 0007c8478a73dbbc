"""Building blocks of the DFC-SA U-Net family (counterpart of dfc_sa_unet_tpu/models/blocks.py).

Module names follow the reference PyTorch state-dict keys, Sequential
indices included (``down1.conv_branch.0.weight``,
``down1.attn_branch.3.query_conv.weight``), so reference checkpoints and
``utils/weights.from_jax_variables`` exports load with ``strict=True``.

Activations are NCHW tensors stored channels_last; the attention core
takes their NHWC views.  The f32 islands of the JAX blocks are kept:
``gamma*out + x`` (blocks.py:66), the gated fusion, and the scaled
residual ``out + res_scale*res`` (blocks.py:140) are summed in f32.

The six block variants share their branches; the U-Net skeleton they all
sit in is built once by ``build_unet`` and run by ``unet_forward``.
"""

import torch
from torch import nn

from dfc_sa_unet_torch.nn.layers import BatchNorm, Conv, ConvTranspose2x2
from dfc_sa_unet_torch.ops.dropout import call_block
from dfc_sa_unet_torch.ops.pooled_attention import pooled_attention
from dfc_sa_unet_torch.ops.pooling import adaptive_avg_pool, max_pool
from dfc_sa_unet_torch.ops.resize import resize_bilinear
from dfc_sa_unet_torch.parallel import rows


def nhwc(t: torch.Tensor) -> torch.Tensor:
    """NCHW -> contiguous NHWC (a free view for channels_last storage)."""
    return t.permute(0, 2, 3, 1).contiguous()


def nchw(t: torch.Tensor) -> torch.Tensor:
    """NHWC -> NCHW view with channels_last strides."""
    return t.permute(0, 3, 1, 2)


class LightSelfAttention(nn.Module):
    """Pooled global self-attention (reference models/unet_dfc_sa_res.py:5-39):
    avg-pool to (p,p) -> 1x1 Q/K at C//qk_div, V at C -> softmax(QK^T) V
    (unscaled) -> bilinear upsample -> gamma*out + x.  Under a band of rows
    (parallel/rows.py) the pool and the upsample are the whole image's: the
    attention then runs on the same p x p map on every rank of the group.

    ``pool_size=None`` is the full-resolution variant (reference
    models/unet_dfc_sa_ablation_attention.py:7-26): the same arithmetic over
    all H*W tokens, no pooling and no upsample.  The 1x1 convs then read x
    itself, and their channels_last outputs are the contiguous NHWC tensors
    the kernel takes, with no copy in between.  Under a band of rows the
    queries are the band's and the keys and values the whole image's,
    gathered over the spatial group (``rows.all_gather_rows``), as JAX's
    GSPMD partitions the einsum: the kernel then takes fewer queries than
    keys.

    The attention core always goes through ops/pooled_attention.py: the
    CUDA kernels on the card (which raise for what they do not take, such
    as N = H*W > 4096), the plain version on CPU tensors.
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
        pooled = x if p is None else adaptive_avg_pool(x, (p, p))
        q, k, v = (conv(pooled) for conv in (self.query_conv, self.key_conv, self.value_conv))
        if p is None and rows.current() is not None:  # the band's queries against every key of the image
            k, v = rows.all_gather_rows(k), rows.all_gather_rows(v)
        out = nchw(pooled_attention(nhwc(q), nhwc(k), nhwc(v)))
        if p is not None:
            out = upsample_pooled(out, (h, w))
        return (self.gamma * out.float() + x.float()).to(x.dtype)


def upsample_pooled(o: torch.Tensor, size) -> torch.Tensor:
    """The pooled attention's bilinear upsample to ``size``: under a band of rows
    (parallel/rows.py) only the band's rows of the whole image's resize."""
    return resize_bilinear(o, size) if rows.current() is None else rows.upsample_band(o, size)


def conv_bn_relu(cin, cout, kernel, compute_dtype):
    """conv(k) + BN + ReLU as the reference's nn.Sequential (indices 0, 1, 2)."""
    return nn.Sequential(Conv(cin, cout, kernel, padding=kernel // 2, compute_dtype=compute_dtype),
                         BatchNorm(cout), nn.ReLU())


def attn_branch(cin, features, pool_size, qk_div, compute_dtype):
    """Conv1x1 + BN + ReLU -> LightSelfAttention (Sequential indices 0..3)."""
    branch = conv_bn_relu(cin, features, 1, compute_dtype)
    branch.append(LightSelfAttention(features, pool_size, qk_div, compute_dtype))
    return branch


class _ResidualBlock(nn.Module):
    """The scaled residual every block ends on: ``out + res_scale * proj(x)``
    summed in f32 (reference models/unet_dfc_sa_res.py:87-93,113-114).  proj
    is a bias-free 1x1 conv when the channel counts differ and the identity
    otherwise (no ``residual_conv`` keys then, as in the reference);
    ``res_scale`` is a learned scalar that starts at 0.1.  A subclass builds
    its branches first and calls ``init_residual`` last, so the modules are
    registered, and seeded weights drawn, in the reference's order."""

    def init_residual(self, cin, features, compute_dtype):
        self.residual_conv = (Conv(cin, features, 1, bias=False, compute_dtype=compute_dtype)
                              if cin != features else None)
        self.res_scale = nn.Parameter(torch.tensor(0.1))

    def add_residual(self, out, x):
        res = x if self.residual_conv is None else self.residual_conv(x)
        return (out.float() + self.res_scale * res.float()).to(out.dtype)


class DFCBlock(_ResidualBlock):
    """DynamicFusionConvAttnBlock (reference models/unet_dfc_sa_res.py:41-116).

    local  = Conv3x3+BN+ReLU
    attn   = Conv1x1+BN+ReLU -> LightSelfAttention
    g      = sigmoid(BN(Conv1x1(cat(local, attn))))
    fused  = g*local + (1-g)*attn
    out    = Conv1x1+BN+ReLU(cat(fused, local, attn)) + res_scale*proj(x)

    ``full_res=True`` swaps in the full-resolution attention (ablation 3,
    reference models/unet_dfc_sa_ablation_attention.py:29-92).
    """

    def __init__(self, cin, features, pool_size=8, qk_div=8, full_res=False, compute_dtype=None):
        super().__init__()
        f = features
        self.conv_branch = conv_bn_relu(cin, f, 3, compute_dtype)
        self.attn_branch = attn_branch(cin, f, None if full_res else pool_size, qk_div, compute_dtype)
        self.gate = nn.Sequential(Conv(2 * f, f, 1, compute_dtype=compute_dtype), BatchNorm(f), nn.Sigmoid())
        self.fusion_conv = conv_bn_relu(3 * f, f, 1, compute_dtype)
        self.init_residual(cin, f, compute_dtype)

    def forward(self, x):
        local = self.conv_branch(x)
        a = self.attn_branch(x)
        g = self.gate(torch.cat([local, a], 1)).float()
        fused = (g * local.float() + (1.0 - g) * a.float()).to(local.dtype)
        out = self.fusion_conv(torch.cat([fused, local, a], 1))
        return self.add_residual(out, x)


class LocalOnlyBlock(_ResidualBlock):
    """Conv branch only + scaled residual (reference
    models/unet_dfc_sa_ablation_branches.py:73-101).  No attention keys."""

    def __init__(self, cin, features, compute_dtype=None):
        super().__init__()
        self.conv_branch = conv_bn_relu(cin, features, 3, compute_dtype)
        self.init_residual(cin, features, compute_dtype)

    def forward(self, x):
        return self.add_residual(self.conv_branch(x), x)


class AttentionOnlyBlock(_ResidualBlock):
    """Attention branch only + scaled residual (reference
    models/unet_dfc_sa_ablation_branches.py:42-70).  The QK reduction is
    fixed at C//8, as in the ablation file's LightSelfAttention."""

    def __init__(self, cin, features, pool_size=8, compute_dtype=None):
        super().__init__()
        self.attn_branch = attn_branch(cin, features, pool_size, 8, compute_dtype)
        self.init_residual(cin, features, compute_dtype)

    def forward(self, x):
        return self.add_residual(self.attn_branch(x), x)


class AdditionFusionBlock(_ResidualBlock):
    """local + attn addition fusion (reference
    models/unet_dfc_sa_ablation_fusion.py:7-48)."""

    def __init__(self, cin, features, pool_size=8, compute_dtype=None):
        super().__init__()
        self.conv_branch = conv_bn_relu(cin, features, 3, compute_dtype)
        self.attn_branch = attn_branch(cin, features, pool_size, 8, compute_dtype)
        self.init_residual(cin, features, compute_dtype)

    def forward(self, x):
        return self.add_residual(self.conv_branch(x) + self.attn_branch(x), x)


class ConcatFusionBlock(_ResidualBlock):
    """concat + 1x1 conv fusion (reference
    models/unet_dfc_sa_ablation_fusion.py:51-100)."""

    def __init__(self, cin, features, pool_size=8, compute_dtype=None):
        super().__init__()
        self.conv_branch = conv_bn_relu(cin, features, 3, compute_dtype)
        self.attn_branch = attn_branch(cin, features, pool_size, 8, compute_dtype)
        self.fusion_conv = conv_bn_relu(2 * features, features, 1, compute_dtype)
        self.init_residual(cin, features, compute_dtype)

    def forward(self, x):
        fused = self.fusion_conv(torch.cat([self.conv_branch(x), self.attn_branch(x)], 1))
        return self.add_residual(fused, x)


# which blocks are recomputed in the backward pass, per ``remat`` mode
# (dfc_sa_unet_tpu/models/blocks.py:270-282): 'l12' the four blocks with the
# largest activations, 'deep' the five whose recompute is mostly matrix work
REMAT_BLOCKS = {
    False: frozenset(),
    None: frozenset(),
    "all": frozenset({"down1", "down2", "down3", "down4", "bottleneck",
                      "up_conv1", "up_conv2", "up_conv3", "up_conv4"}),
    "l12": frozenset({"down1", "down2", "up_conv1", "up_conv2"}),
    "deep": frozenset({"down3", "down4", "bottleneck", "up_conv3", "up_conv4"}),
}
REMAT_BLOCKS[True] = REMAT_BLOCKS["all"]


def build_unet(model: nn.Module, in_channels, out_channels, features, enc_factory, dec_factory,
               compute_dtype=None) -> None:
    """Hang the skeleton's modules on ``model``: down1..4 and the bottleneck
    (at twice the last width) from ``enc_factory(cin, features)``, up1..4
    (ConvTranspose 2x2), up_conv1..4 from ``dec_factory(cin, features)`` and
    final_conv.  The bottleneck follows the encoder's block kind, as in
    every reference variant."""
    f = list(features)
    cins = [in_channels] + f[:3]
    for i in range(4):
        setattr(model, f"down{i + 1}", enc_factory(cins[i], f[i]))
    model.bottleneck = enc_factory(f[3], f[3] * 2)
    ups = [f[3] * 2] + f[3:0:-1]  # channels entering up4, up3, up2, up1
    for i, cin in zip(range(4, 0, -1), ups):
        setattr(model, f"up{i}", ConvTranspose2x2(cin, f[i - 1], compute_dtype=compute_dtype))
        setattr(model, f"up_conv{i}", dec_factory(2 * f[i - 1], f[i - 1]))
    model.final_conv = Conv(f[0], out_channels, 1, compute_dtype=compute_dtype)


def unet_forward(model: nn.Module, x: torch.Tensor, remat=False) -> torch.Tensor:
    """The 4-level U-Net wiring (reference models/unet_dfc_sa_res.py:161-204):
    encoder blocks + MaxPool(2), bottleneck, ConvTranspose(2,2) decoder with a
    bilinear shape fix and the skip concat, final 1x1 conv.  ``model`` holds
    the modules of ``build_unet``.  ``remat`` (False, 'all', 'l12' or 'deep')
    names the blocks whose activations are recomputed in the backward pass
    instead of kept."""
    if remat not in REMAT_BLOCKS:
        raise ValueError(f"remat must be one of False, 'all', 'l12', 'deep'; got {remat!r}")
    names = REMAT_BLOCKS[remat]

    def block(name, h):
        return call_block(model, name in names, getattr(model, name), h)

    skips = []
    h = x
    for i in range(1, 5):
        h = block(f"down{i}", h)
        skips.append(h)
        h = max_pool(h, 2, 2)
    h = block("bottleneck", h)
    for i in range(4, 0, -1):
        skip = skips[i - 1]
        h = getattr(model, f"up{i}")(h)
        if h.shape[2:] != skip.shape[2:]:  # never under a band: its height is even at every level
            assert rows.current() is None, f"the decoder's shape fix under a band of rows: {tuple(h.shape)}"
            h = resize_bilinear(h, skip.shape[2:])
        h = block(f"up_conv{i}", torch.cat([h, skip], 1))
    return model.final_conv(h)


__all__ = ["AdditionFusionBlock", "AttentionOnlyBlock", "ConcatFusionBlock", "DFCBlock", "LightSelfAttention",
           "LocalOnlyBlock", "REMAT_BLOCKS", "build_unet", "conv_bn_relu", "nchw", "nhwc", "unet_forward"]
