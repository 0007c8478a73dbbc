"""Official-style TransUNet R50-ViT-B/16 (counterpart of
dfc_sa_unet_tpu/models/transunet.py; reference models/transformer_unet.py).

ResNetV2 hybrid backbone (weight-standardised convs + GroupNorm,
pre-activation bottlenecks, units (3,4,9)) -> patch embeddings + learned
position embeddings -> 12 *pre-norm* transformer blocks -> DecoderCup
(conv_more + 4 bilinear-x2 decoder blocks with 3 skips) -> 3x3 head.
One-channel inputs are repeated to 3 channels like the reference.

Takes normalised NCHW images (stored channels_last) and returns NCHW
logits in the compute dtype.  Token tensors are ``[B,N,E]``.  The
attention core of every block is the ``fused_mha_sep`` kernel wrapper; in
training with dropout on the attention weights (0 in the R50-ViT-B/16
config) it takes the plain path, as the JAX model does (transunet.py:174-206).
``remat`` recomputes every ResNet unit, encoder block and decoder block in
the backward pass.
"""

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from dfc_sa_unet_torch.models.vit_seg import gelu, map_from_tokens, tokens_from_map
from dfc_sa_unet_torch.nn.layers import BatchNorm, Conv, Dense, GroupNorm, LayerNorm, WSConv
from dfc_sa_unet_torch.ops.dropout import call_block, dropout, dropout_generator
from dfc_sa_unet_torch.ops.mha import fused_mha_sep, fused_mha_sep_plain
from dfc_sa_unet_torch.ops.pooling import max_pool
from dfc_sa_unet_torch.ops.resize import resize_bilinear

HEAD_CHANNELS = 512  # conv_more's width


def get_r50_b16_config() -> Dict[str, Any]:
    """R50+ViT-B/16 hyperparameters (reference models/transformer_unet.py:318-342)."""
    return {
        "patches_grid": (14, 14),
        "resnet_num_layers": (3, 4, 9),
        "resnet_width_factor": 1,
        "hidden_size": 768,
        "mlp_dim": 3072,
        "num_heads": 12,
        "num_layers": 12,
        "attention_dropout_rate": 0.0,
        "dropout_rate": 0.1,
        "decoder_channels": (256, 128, 64, 16),
        "skip_channels": [512, 256, 64, 16],
        "n_classes": 9,
        "n_skip": 3,
    }


class PreActBottleneck(nn.Module):
    """Pre-activation bottleneck (reference models/transformer_unet.py:40-68).
    Kept as the reference has it: gn1, gn2 and gn3 use eps 1e-6; gn_proj is
    GroupNorm(cout, cout), one group per channel, with eps 1e-5."""

    def __init__(self, cin, cout, cmid, stride=1, compute_dtype=None):
        super().__init__()
        self.conv1 = WSConv(cin, cmid, 1, compute_dtype=compute_dtype)
        self.gn1 = GroupNorm(32, cmid, eps=1e-6)
        self.conv2 = WSConv(cmid, cmid, 3, stride=stride, padding=1, compute_dtype=compute_dtype)
        self.gn2 = GroupNorm(32, cmid, eps=1e-6)
        self.conv3 = WSConv(cmid, cout, 1, compute_dtype=compute_dtype)
        self.gn3 = GroupNorm(32, cout, eps=1e-6)
        if stride != 1 or cin != cout:
            self.downsample = WSConv(cin, cout, 1, stride=stride, compute_dtype=compute_dtype)
            self.gn_proj = GroupNorm(cout, cout, eps=1e-5)

    def forward(self, x):
        residual = x
        if hasattr(self, "downsample"):
            residual = self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return F.relu(residual + y)


class _Root(nn.Module):
    def __init__(self, cin, width, compute_dtype=None):
        super().__init__()
        self.conv = WSConv(cin, width, 7, stride=2, padding=3, compute_dtype=compute_dtype)
        self.gn = GroupNorm(32, width, eps=1e-6)

    def forward(self, x):
        return F.relu(self.gn(self.conv(x)))


class _ResBlock(nn.Sequential):
    """``unit1`` .. ``unitN``, the first one strided and widening."""

    def __init__(self, units, cin, cout, cmid, first_stride, compute_dtype, remat=False):
        super().__init__()
        self.remat = remat
        for i in range(1, units + 1):
            self.add_module(f"unit{i}", PreActBottleneck(cin if i == 1 else cout, cout, cmid,
                                                         first_stride if i == 1 else 1, compute_dtype))

    def forward(self, x):
        for unit in self:
            x = call_block(self, self.remat, unit, x)
        return x


class _Body(nn.Module):
    """The three bottleneck stages, ``block1`` .. ``block3``."""

    def __init__(self, block_units, width, compute_dtype=None, remat=False):
        super().__init__()
        w = width
        self.block1 = _ResBlock(block_units[0], w, w * 4, w, 1, compute_dtype, remat)
        self.block2 = _ResBlock(block_units[1], w * 4, w * 8, w * 2, 2, compute_dtype, remat)
        self.block3 = _ResBlock(block_units[2], w * 8, w * 16, w * 4, 2, compute_dtype, remat)

    def forward(self, x):
        b1 = self.block1(x)
        b2 = self.block2(b1)
        return self.block3(b2), (b1, b2)


class ResNetV2(nn.Module):
    """Hybrid backbone (reference models/transformer_unet.py:70-106).  Returns
    (x, [block2_out, block1_out, root_out]): the skips, highest resolution last."""

    def __init__(self, block_units=(3, 4, 9), width_factor=1, in_channels=3, compute_dtype=None, remat=False):
        super().__init__()
        self.width = int(64 * width_factor)
        self.root = _Root(in_channels, self.width, compute_dtype)
        self.body = _Body(block_units, self.width, compute_dtype, remat)

    def forward(self, x):
        root_out = self.root(x)
        y, (b1_out, b2_out) = self.body(max_pool(root_out, 3, 2, padding=1))
        return y, [b2_out, b1_out, root_out]


class _Attention(nn.Module):
    """TransUNet attention (reference models/transformer_unet.py:116-157):
    separate query / key / value / out Linears around fused_mha_sep.
    ``attn_dropout`` (0 in the R50-ViT-B/16 config) applies to the attention
    weights, which the kernel never materialises, so training with it takes
    the plain path; it also applies to the projected output, as in the reference."""

    def __init__(self, hidden, num_heads, attn_dropout=0.0, compute_dtype=None):
        super().__init__()
        self.num_heads, self.attn_dropout = num_heads, attn_dropout
        self.query = Dense(hidden, hidden, compute_dtype=compute_dtype)
        self.key = Dense(hidden, hidden, compute_dtype=compute_dtype)
        self.value = Dense(hidden, hidden, compute_dtype=compute_dtype)
        self.out = Dense(hidden, hidden, compute_dtype=compute_dtype)

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)
        gen = dropout_generator(self)
        if self.training and self.attn_dropout > 0.0:
            out = fused_mha_sep_plain(q, k, v, self.num_heads, self.attn_dropout, gen)
        else:
            out = fused_mha_sep(q, k, v, self.num_heads)
        return dropout(self.out(out), self.attn_dropout, self.training, gen)


class _Mlp(nn.Module):
    def __init__(self, hidden, mlp_dim, dropout, compute_dtype=None):
        super().__init__()
        self.dropout = dropout
        self.fc1 = Dense(hidden, mlp_dim, compute_dtype=compute_dtype)
        self.fc2 = Dense(mlp_dim, hidden, compute_dtype=compute_dtype)

    def forward(self, x):
        gen = dropout_generator(self)
        y = dropout(gelu(self.fc1(x)), self.dropout, self.training, gen)
        return dropout(self.fc2(y), self.dropout, self.training, gen)


class _VitBlock(nn.Module):
    """Pre-norm transformer block (reference models/transformer_unet.py:202-220)."""

    def __init__(self, cfg, compute_dtype=None):
        super().__init__()
        hidden = cfg["hidden_size"]
        self.attention_norm = LayerNorm(hidden, eps=1e-6)
        self.attn = _Attention(hidden, cfg["num_heads"], cfg["attention_dropout_rate"], compute_dtype)
        self.ffn_norm = LayerNorm(hidden, eps=1e-6)
        self.ffn = _Mlp(hidden, cfg["mlp_dim"], cfg["dropout_rate"], compute_dtype)

    def forward(self, x):
        x = self.attn(self.attention_norm(x)) + x
        return self.ffn(self.ffn_norm(x)) + x


class _Encoder(nn.Module):
    def __init__(self, cfg, compute_dtype=None, remat=False):
        super().__init__()
        self.remat = remat
        self.layer = nn.ModuleList(_VitBlock(cfg, compute_dtype) for _ in range(cfg["num_layers"]))
        self.encoder_norm = LayerNorm(cfg["hidden_size"], eps=1e-6)

    def forward(self, x):
        for block in self.layer:
            x = call_block(self, self.remat, block, x)
        return self.encoder_norm(x)


class _Embeddings(nn.Module):
    def __init__(self, cfg, img_size, compute_dtype=None, remat=False):
        super().__init__()
        grid = cfg["patches_grid"]
        patch = (img_size // 16 // grid[0], img_size // 16 // grid[1])
        self.n_patches = (img_size // 16) * (img_size // 16)
        self.dropout = cfg["dropout_rate"]
        self.hybrid_model = ResNetV2(cfg["resnet_num_layers"], cfg["resnet_width_factor"],
                                     compute_dtype=compute_dtype, remat=remat)
        self.patch_embeddings = Conv(self.hybrid_model.width * 16, cfg["hidden_size"], patch, stride=patch,
                                     compute_dtype=compute_dtype)
        self.position_embeddings = nn.Parameter(torch.zeros(1, self.n_patches, cfg["hidden_size"]))

    def forward(self, x):
        y, features = self.hybrid_model(x)
        y = tokens_from_map(self.patch_embeddings(y))
        if y.shape[1] != self.n_patches:
            raise ValueError(f"an input of {tuple(x.shape[2:])} gives {y.shape[1]} tokens; the model's "
                             f"position embeddings hold {self.n_patches}")
        return dropout(y + self.position_embeddings, self.dropout, self.training, dropout_generator(self)), features


class _Transformer(nn.Module):
    def __init__(self, cfg, img_size, compute_dtype=None, remat=False):
        super().__init__()
        self.embeddings = _Embeddings(cfg, img_size, compute_dtype, remat)
        self.encoder = _Encoder(cfg, compute_dtype, remat)

    def forward(self, x):
        y, features = self.embeddings(x)
        return self.encoder(y), features


def _conv2d_relu(cin, cout, kernel, padding, compute_dtype):
    return nn.Sequential(Conv(cin, cout, kernel, padding=padding, bias=False, compute_dtype=compute_dtype),
                         BatchNorm(cout), nn.ReLU())


class _DecoderBlock(nn.Module):
    def __init__(self, cin, cout, skip_channels=0, compute_dtype=None):
        super().__init__()
        self.conv1 = _conv2d_relu(cin + skip_channels, cout, 3, 1, compute_dtype)
        self.conv2 = _conv2d_relu(cout, cout, 3, 1, compute_dtype)

    def forward(self, x, skip=None):
        h, w = x.shape[2:]
        x = resize_bilinear(x, (2 * h, 2 * w), align_corners=True)  # UpsamplingBilinear2d
        if skip is not None:
            x = torch.cat([x, skip], dim=1)
        return self.conv2(self.conv1(x))


class _DecoderCup(nn.Module):
    def __init__(self, cfg, width, compute_dtype=None, remat=False):
        super().__init__()
        self.remat = remat
        self.n_skip = cfg["n_skip"]
        self.conv_more = _conv2d_relu(cfg["hidden_size"], HEAD_CHANNELS, 3, 1, compute_dtype)
        outs = list(cfg["decoder_channels"])
        ins = [HEAD_CHANNELS] + outs[:-1]
        skips = [width * 8, width * 4, width]  # block2, block1 and root of the backbone
        self.blocks = nn.ModuleList(
            _DecoderBlock(cin, cout, skips[i] if i < min(self.n_skip, len(skips)) else 0, compute_dtype)
            for i, (cin, cout) in enumerate(zip(ins, outs)))

    def forward(self, hidden_states, features):
        n_patch = hidden_states.shape[1]
        side = int(n_patch ** 0.5)
        x = self.conv_more(map_from_tokens(hidden_states, side, side))
        for i, block in enumerate(self.blocks):
            x = call_block(self, self.remat, block, x, features[i] if i < min(self.n_skip, len(features)) else None)
        return x


class TransUNet(nn.Module):
    """Factory names 'TransformerUNet' / 'TransUNet'."""

    def __init__(self, config, img_size=224, num_classes=9, compute_dtype=None, remat=False):
        super().__init__()
        self.config, self.img_dim, self.num_classes = dict(config), img_size, num_classes
        self.transformer = _Transformer(config, img_size, compute_dtype, remat)
        self.decoder = _DecoderCup(config, self.transformer.embeddings.hybrid_model.width, compute_dtype, remat)
        self.segmentation_head = nn.Sequential(
            Conv(config["decoder_channels"][-1], config["n_classes"], 3, padding=1, compute_dtype=compute_dtype))

    def forward(self, x):
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        y, features = self.transformer(x)
        return self.segmentation_head(self.decoder(y, features))
