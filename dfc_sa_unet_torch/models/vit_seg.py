"""Plain ViT segmenter (counterpart of dfc_sa_unet_tpu/models/vit_seg.py;
reference models/vision_transformer.py:5-174).

Patch embedding (strided conv) + learned position embedding + a stack of
torch-style *post-norm* encoder layers (exact GELU) + a segmentation head
of ConvTranspose(k=4, s=2, p=1) + BatchNorm + ReLU stages and a 1x1 conv,
with a bilinear resize if the output size still differs from the input's.

Takes normalised NCHW images (stored channels_last) of exactly
``img_dim`` x ``img_dim`` and returns NCHW logits in the compute dtype.
Token tensors are ``[B,N,E]``.  The attention core of every layer is the
``fused_mha`` kernel wrapper: scaled by 1/sqrt(head_dim), unlike the DFC
pooled attention.  In training with dropout on the attention weights the
core takes the plain path instead, as the JAX model does (vit_seg.py:84-105):
the kernel never materialises the weights.  Dropout masks come from the
generator set by ``ops.dropout.set_dropout_generator``.
"""

import torch
import torch.nn.functional as F
from torch import nn

from dfc_sa_unet_torch.nn.layers import BatchNorm, Conv, ConvTranspose, Dense, LayerNorm, add_bias_
from dfc_sa_unet_torch.ops.dropout import call_block, dropout, dropout_generator
from dfc_sa_unet_torch.ops.mha import fused_mha, fused_mha_plain
from dfc_sa_unet_torch.ops.resize import resize_bilinear


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU computed in f32, returned in the input dtype."""
    return F.gelu(x.float()).to(x.dtype)


def tokens_from_map(y: torch.Tensor) -> torch.Tensor:
    """[B,E,h,w] -> [B,h*w,E]; a view of a channels_last tensor."""
    b, e, h, w = y.shape
    return y.permute(0, 2, 3, 1).reshape(b, h * w, e)


def map_from_tokens(y: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[B,h*w,E] -> [B,E,h,w] stored channels_last (a view)."""
    b, _, e = y.shape
    return y.reshape(b, h, w, e).permute(0, 3, 1, 2)


class PatchEmbedding(nn.Module):
    def __init__(self, in_channels, patch_dim, embed_dim, compute_dtype=None):
        super().__init__()
        self.proj = Conv(in_channels, embed_dim, patch_dim, stride=patch_dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return tokens_from_map(self.proj(x))


class TorchMultiheadAttention(nn.Module):
    """Self-attention with torch.nn.MultiheadAttention's packed parameters
    (``in_proj_weight`` [3E,E], ``in_proj_bias``, ``out_proj``), so the
    reference's checkpoints load key for key: in_proj -> fused_mha ->
    out_proj.  ``dropout`` is the rate on the attention weights; the
    kernel has none, so training with it takes the plain path."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, compute_dtype=None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.compute_dtype = compute_dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = Dense(embed_dim, embed_dim, compute_dtype=compute_dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        dtype = self.compute_dtype or x.dtype
        qkv = add_bias_(F.linear(x.to(dtype), self.in_proj_weight.to(dtype)), self.in_proj_bias)
        if self.training and self.dropout > 0.0:
            out = fused_mha_plain(qkv, self.num_heads, self.dropout, dropout_generator(self))
        else:
            out = fused_mha(qkv, self.num_heads)
        return self.out_proj(out)


class TorchEncoderLayer(nn.Module):
    """torch.nn.TransformerEncoderLayer, post-norm: x = norm1(x + SA(x));
    x = norm2(x + FF(x)); LayerNorm eps 1e-5."""

    def __init__(self, embed_dim, num_heads, mlp_dim, dropout=0.1, compute_dtype=None):
        super().__init__()
        self.dropout = dropout
        self.self_attn = TorchMultiheadAttention(embed_dim, num_heads, dropout, compute_dtype)
        self.linear1 = Dense(embed_dim, mlp_dim, compute_dtype=compute_dtype)
        self.linear2 = Dense(mlp_dim, embed_dim, compute_dtype=compute_dtype)
        self.norm1 = LayerNorm(embed_dim, eps=1e-5)
        self.norm2 = LayerNorm(embed_dim, eps=1e-5)

    def _drop(self, x):
        return dropout(x, self.dropout, self.training, dropout_generator(self))

    def forward(self, x):
        x = self.norm1(x + self._drop(self.self_attn(x)))
        h = self.linear2(self._drop(gelu(self.linear1(x))))
        return self.norm2(x + self._drop(h))


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers, embed_dim, num_heads, mlp_dim, dropout, compute_dtype=None, remat=False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            TorchEncoderLayer(embed_dim, num_heads, mlp_dim, dropout, compute_dtype) for _ in range(num_layers))

    def forward(self, x):
        for layer in self.layers:
            x = call_block(self, self.remat, layer, x)
        return x


class VisionTransformerForSegmentation(nn.Module):
    """Factory name 'VisionTransformerSegmentation'."""

    def __init__(self, img_dim=224, patch_dim=16, in_channels=3, num_classes=1, embed_dim=768,
                 num_layers=12, num_heads=12, mlp_dim=3072, dropout=0.1, upsample_layers=4,
                 compute_dtype=None, remat=False):
        super().__init__()
        self.img_dim, self.patch_dim, self.dropout = img_dim, patch_dim, dropout
        feat = img_dim // patch_dim
        self.patch_embed = PatchEmbedding(in_channels, patch_dim, embed_dim, compute_dtype)
        self.pos_embed = nn.Parameter(torch.randn(1, feat * feat, embed_dim))
        self.transformer_encoder = TransformerEncoder(num_layers, embed_dim, num_heads, mlp_dim, dropout,
                                                      compute_dtype, remat)
        # channel schedule of reference models/vision_transformer.py:107-123
        head, current = [], embed_dim
        for i in range(upsample_layers):
            out_ch = current // 2
            if out_ch < num_classes * 4 and i < upsample_layers - 1:
                out_ch = num_classes * 4 if num_classes * 4 < current else current // 2
            head += [ConvTranspose(current, out_ch, kernel_size=4, stride=2, padding=1, compute_dtype=compute_dtype),
                     BatchNorm(out_ch), nn.ReLU()]
            current = out_ch
        head.append(Conv(current, num_classes, 1, compute_dtype=compute_dtype))
        self.segmentation_head = nn.Sequential(*head)

    def forward(self, x):
        b, _, h, w = x.shape
        if (h, w) != (self.img_dim, self.img_dim):
            raise ValueError(f"input image size ({h}x{w}) doesn't match the model's ({self.img_dim}x{self.img_dim})")
        feat = self.img_dim // self.patch_dim
        y = self.patch_embed(x)
        y = dropout(y + self.pos_embed, self.dropout, self.training, dropout_generator(self))
        y = self.transformer_encoder(y)
        logits = self.segmentation_head(map_from_tokens(y, feat, feat))
        return resize_bilinear(logits, (h, w), align_corners=False)
