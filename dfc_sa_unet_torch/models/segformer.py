"""SegFormer (Xie et al., "SegFormer: Simple and Efficient Design for Semantic Segmentation with
Transformers", NeurIPS 2021, arXiv:2105.15203): the Mix Transformer encoder (``mit_b*`` of the
NVlabs code's mmseg/models/backbones/mix_transformer.py) and the all-MLP decode head
(mmseg/models/decode_heads/segformer_head.py).  The factory's name is ``SegFormer``; its defaults
are MiT-B5 with the 768-wide head, as local_configs/segformer/B5/segformer.b5.1024x1024.city.160k.py
sets them.  This model has no counterpart in the JAX package.

* Four stages of widths ``embed_dims``, each an overlapping patch embedding (a 7x7 conv at stride 4,
  padding 3, then 3x3 convs at stride 2, padding 1; a LayerNorm of torch's default eps), ``depths``
  blocks and a LayerNorm (eps 1e-6).
* A block: x + attention(LayerNorm(x)), then x + Mix-FFN(LayerNorm(x)), both norms eps 1e-6.  The
  efficient attention takes every token's query against keys and values of the map cut by its
  reduction ratio R (an R x R conv at stride R and a LayerNorm of torch's default eps; none where R
  = 1), ``num_heads`` heads of softmax(q k^T / sqrt(head dim)) v, then a linear projection.  The
  Mix-FFN: a linear layer to ``mlp_ratio`` times the width, a depthwise 3x3 conv, the exact GELU,
  a linear layer back.
* The head: each stage's map through a linear layer to ``decoder_dim``, bilinearly resized
  (align_corners=False) to the first stage's 1/4 resolution, concatenated as [c4, c3, c2, c1], a
  1x1 conv without bias, BatchNorm and ReLU (``linear_fuse``), and a 1x1 conv to the classes
  (``linear_pred``); the logits are resized to the input's size, as mmseg's encode_decode does.

State-dict keys are the NVlabs code's: ``backbone.patch_embed{i}.{proj,norm}``,
``backbone.block{i}.{j}.{norm1,attn.{q,kv,sr,norm,proj},norm2,mlp.{fc1,dwconv.dwconv,fc2}}``,
``backbone.norm{i}``, ``decode_head.linear_c{i}.proj``, ``decode_head.linear_fuse.{conv,bn}`` and
``decode_head.linear_pred``.  A published checkpoint also holds ``decode_head.conv_seg`` (the base
head's classifier, which SegFormer's forward never calls): load it with that key dropped.

Takes normalised NCHW images (stored channels_last) whose sides are multiples of 32 (mmseg pads to
that; ``tile_multiple``) and returns NCHW logits in the compute dtype.  Token tensors are
``[B,N,C]``.  The attention's core is the pooled-attention kernel with more queries than keys and
``heads`` heads (``ops/pooled_attention.py``): q straight from its linear layer with the scale 1 /
sqrt(head dim) folded into that layer's weight and bias (exact for SegFormer's head dim 64: a
power of two), k and v the two halves of the kv layer's output, read where they lie.  Eval only in
one respect: dropout and drop path (the source's 0.1 of each in training) are not applied.  Row
sharding (parallel/rows.py) raises: the reduced keys span the whole image.

Under a ``torch.profiler`` session the forward's parts are timed spans (``utils/profiling.py``):
``segformer.attention`` (each block's first residual branch with its norm and add: the reduction
conv and norm, q and kv, the kernel, the projection), ``segformer.mix_ffn`` (the second, with its
norm and add) and ``segformer.decoder`` (the head and the resize of the logits).
"""

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from dfc_sa_unet_torch.models.vit_seg import gelu, map_from_tokens, tokens_from_map
from dfc_sa_unet_torch.nn.layers import BatchNorm, Conv, Dense, LayerNorm, add_bias_
from dfc_sa_unet_torch.ops.dropout import call_block
from dfc_sa_unet_torch.ops.pooled_attention import pooled_attention
from dfc_sa_unet_torch.ops.resize import resize_bilinear
from dfc_sa_unet_torch.parallel import rows
from dfc_sa_unet_torch.utils.profiling import span

# MiT-B5 with the B5 head (the source's Cityscapes 1024x1024 config)
B5 = {"embed_dims": (64, 128, 320, 512), "depths": (3, 6, 40, 3), "num_heads": (1, 2, 5, 8),
      "sr_ratios": (8, 4, 2, 1), "mlp_ratio": 4, "decoder_dim": 768}
BLOCK_EPS = 1e-6  # norm_layer=partial(nn.LayerNorm, eps=1e-6): the blocks' and the stages' norms


class _ScaledDense(Dense):
    """``Dense`` times ``scale``, folded into its weight and bias (exact where ``scale`` is a power of
    two: every product and partial sum scales alike)."""

    def __init__(self, cin, cout, scale, compute_dtype=None):
        super().__init__(cin, cout, compute_dtype=compute_dtype)
        self.scale = scale

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        return add_bias_(F.linear(x.to(dtype), (self.weight * self.scale).to(dtype)), self.bias * self.scale)


class _DepthwiseConv(nn.Conv2d):
    """The Mix-FFN's 3x3 depthwise conv at padding 1, with a bias, in ``compute_dtype``."""

    def __init__(self, channels, compute_dtype=None):
        super().__init__(channels, channels, 3, padding=1, groups=channels)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        y = F.conv2d(x.to(dtype), self.weight.to(dtype), None, 1, 1, 1, self.groups)
        return add_bias_(y, self.bias.view(-1, 1, 1))


class _OverlapPatchEmbed(nn.Module):
    def __init__(self, cin, dim, patch, stride, compute_dtype=None):
        super().__init__()
        self.proj = Conv(cin, dim, patch, stride=stride, padding=patch // 2, compute_dtype=compute_dtype)
        self.norm = LayerNorm(dim)

    def forward(self, x):
        """NCHW map -> (tokens [B,N,C], h, w)."""
        y = self.proj(x)
        h, w = y.shape[2:]
        return self.norm(tokens_from_map(y)), h, w


class _Attention(nn.Module):
    """The efficient self-attention: queries of every token, keys and values of the map cut by
    ``sr_ratio``."""

    def __init__(self, dim, num_heads, sr_ratio, compute_dtype=None):
        super().__init__()
        self.num_heads, self.sr_ratio = num_heads, sr_ratio
        self.q = _ScaledDense(dim, dim, (dim // num_heads) ** -0.5, compute_dtype)
        self.kv = Dense(dim, 2 * dim, compute_dtype=compute_dtype)
        self.proj = Dense(dim, dim, compute_dtype=compute_dtype)
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, stride=sr_ratio, compute_dtype=compute_dtype)
            self.norm = LayerNorm(dim)

    def forward(self, x, h, w):
        q = self.q(x)
        y = x if self.sr_ratio == 1 else self.norm(tokens_from_map(self.sr(map_from_tokens(x, h, w))))
        kv = self.kv(y)
        c = x.shape[-1]
        return self.proj(pooled_attention(q, kv[..., :c], kv[..., c:], self.num_heads))


class _DWConv(nn.Module):
    def __init__(self, channels, compute_dtype=None):
        super().__init__()
        self.dwconv = _DepthwiseConv(channels, compute_dtype)

    def forward(self, x, h, w):
        return tokens_from_map(self.dwconv(map_from_tokens(x, h, w)))


class _MixFFN(nn.Module):
    def __init__(self, dim, hidden, compute_dtype=None):
        super().__init__()
        self.fc1 = Dense(dim, hidden, compute_dtype=compute_dtype)
        self.dwconv = _DWConv(hidden, compute_dtype)
        self.fc2 = Dense(hidden, dim, compute_dtype=compute_dtype)

    def forward(self, x, h, w):
        return self.fc2(gelu(self.dwconv(self.fc1(x), h, w)))


class _Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, sr_ratio, compute_dtype=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=BLOCK_EPS)
        self.attn = _Attention(dim, num_heads, sr_ratio, compute_dtype)
        self.norm2 = LayerNorm(dim, eps=BLOCK_EPS)
        self.mlp = _MixFFN(dim, dim * mlp_ratio, compute_dtype)

    def forward(self, x, h, w):
        with span("segformer.attention", timed=True):
            x = x + self.attn(self.norm1(x), h, w)
        with span("segformer.mix_ffn", timed=True):
            return x + self.mlp(self.norm2(x), h, w)


class MixVisionTransformer(nn.Module):
    """The encoder; returns the four stages' maps (NCHW, channels_last), at 1/4 .. 1/32."""

    def __init__(self, in_channels, embed_dims, depths, num_heads, sr_ratios, mlp_ratio, compute_dtype=None,
                 remat=False):
        super().__init__()
        self.remat, self.stages = remat, len(embed_dims)
        cin = in_channels
        for i, (dim, depth, heads, sr) in enumerate(zip(embed_dims, depths, num_heads, sr_ratios), start=1):
            patch, stride = (7, 4) if i == 1 else (3, 2)
            setattr(self, f"patch_embed{i}", _OverlapPatchEmbed(cin, dim, patch, stride, compute_dtype))
            setattr(self, f"block{i}", nn.ModuleList(_Block(dim, heads, mlp_ratio, sr, compute_dtype)
                                                      for _ in range(depth)))
            setattr(self, f"norm{i}", LayerNorm(dim, eps=BLOCK_EPS))
            cin = dim

    def forward(self, x):
        outs = []
        for i in range(1, self.stages + 1):
            t, h, w = getattr(self, f"patch_embed{i}")(x)
            for block in getattr(self, f"block{i}"):
                t = call_block(self, self.remat, block, t, h, w)
            x = map_from_tokens(getattr(self, f"norm{i}")(t), h, w)
            outs.append(x)
        return outs


class _MLP(nn.Module):
    """A stage's linear embedding to the head's width (the source's MLP: ``proj``)."""

    def __init__(self, cin, dim, compute_dtype=None):
        super().__init__()
        self.proj = Dense(cin, dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return map_from_tokens(self.proj(tokens_from_map(x)), *x.shape[2:])


class _ConvModule(nn.Module):
    """mmcv's ConvModule as the head builds it: a 1x1 conv without bias, BatchNorm, ReLU."""

    def __init__(self, cin, cout, compute_dtype=None):
        super().__init__()
        self.conv = Conv(cin, cout, 1, bias=False, compute_dtype=compute_dtype)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


class SegFormerHead(nn.Module):
    def __init__(self, in_channels: Sequence[int], dim, num_classes, compute_dtype=None):
        super().__init__()
        self.stages = len(in_channels)
        for i, cin in enumerate(in_channels, start=1):
            setattr(self, f"linear_c{i}", _MLP(cin, dim, compute_dtype))
        self.linear_fuse = _ConvModule(dim * self.stages, dim, compute_dtype)
        self.linear_pred = Conv(dim, num_classes, 1, compute_dtype=compute_dtype)

    def forward(self, feats):
        size = feats[0].shape[2:]
        ups = [resize_bilinear(getattr(self, f"linear_c{i}")(feats[i - 1]), size)
               for i in range(self.stages, 0, -1)]
        return self.linear_pred(self.linear_fuse(torch.cat(ups, dim=1)))


class SegFormer(nn.Module):
    """Factory name 'SegFormer'."""

    tile_multiple = 32  # the coarsest stage's stride: mmseg pads inputs to it

    def __init__(self, in_channels=3, num_classes=1, embed_dims=B5["embed_dims"], depths=B5["depths"],
                 num_heads=B5["num_heads"], sr_ratios=B5["sr_ratios"], mlp_ratio=B5["mlp_ratio"],
                 decoder_dim=B5["decoder_dim"], compute_dtype=None, remat=False):
        super().__init__()
        self.num_classes = num_classes
        self.backbone = MixVisionTransformer(in_channels, embed_dims, depths, num_heads, sr_ratios, mlp_ratio,
                                             compute_dtype, remat)
        self.decode_head = SegFormerHead(embed_dims, decoder_dim, num_classes, compute_dtype)

    def forward(self, x):
        if rows.current() is not None:
            raise rows.unported("SegFormer, whose reduced keys span the whole image")
        feats = self.backbone(x)
        with span("segformer.decoder", timed=True):
            return resize_bilinear(self.decode_head(feats), x.shape[2:])
