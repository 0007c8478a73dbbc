"""Plain float32 reference of TransUNet R50-ViT-B/16 (Chen et al., arXiv:2102.04306, and its
published code's vit_seg_modeling.py / vit_seg_modeling_resnet_skip.py), written over a state
dict with the keys of that code, for serving (eval mode: no dropout, BatchNorm on its running
statistics).

* ResNetV2 hybrid: a weight-standardised 7x7/2 root conv (per output channel, biased variance,
  eps 1e-5), GroupNorm(32, eps 1e-6), ReLU, a 3x3/2 max pool at padding 1; three stages of
  pre-activation bottlenecks, (3, 4, 9) units, widths 256 / 512 / 1024, the stride on the first
  unit's 3x3 conv and its projection (GroupNorm with one group a channel, eps 1e-5);
* 1x1 patch embeddings to 768, learned position embeddings over 14x14 tokens;
* 12 pre-norm blocks: LayerNorm(eps 1e-6), 12 heads of 64 with separate q / k / v / out
  linears, softmax(q k^T / 8) v; LayerNorm, MLP 768 -> 3072 -> 768 with the exact GELU; a final
  LayerNorm;
* the decoder cup: a 3x3 conv to 512 + BatchNorm + ReLU on the 14x14 map (at 224 x 224), four blocks of an
  align-corners bilinear 2x upsample, the skip (block2, block1 and root outputs, then none)
  concatenated, two 3x3 conv + BatchNorm + ReLU (256, 128, 64, 16), and a 3x3 head with a bias.
"""

import torch
import torch.nn.functional as F

from portbench.reference.plain import Norms, Precision

HIDDEN, MLP, HEADS, LAYERS = 768, 3072, 12, 12
UNITS = (3, 4, 9)
DECODER = (256, 128, 64, 16)
HEAD_CHANNELS = 512


def _stages(width=64):
    """(prefix, cin, cout, cmid, stride) of every bottleneck unit."""
    out, cin = [], width
    for s, (units, mult, stride) in enumerate(zip(UNITS, (4, 8, 16), (1, 2, 2)), start=1):
        cout, cmid = width * mult, width * mult // 4
        for u in range(1, units + 1):
            out.append((f"transformer.embeddings.hybrid_model.body.block{s}.unit{u}", cin if u == 1 else cout, cout,
                        cmid, stride if u == 1 else 1))
        cin = cout
    return out


def state_spec(config) -> dict:
    """{key: (shape, draw)} of every parameter and BatchNorm statistic (see
    dfc_sa_res_block.state_spec for the draws); the position embeddings hold one token a 16 x 16
    patch of the configuration's image size."""
    m = config["model"]
    height, width = config["dataset"]["img_size"]
    spec = {}

    def w(key, shape, fan_in, gain=2.0):
        spec[key] = (shape, ("normal", 0.0, (gain / fan_in) ** 0.5))

    def affine(key, c, bn=False):
        spec[f"{key}.weight"] = ((c,), ("normal", 1.0, 0.1))
        spec[f"{key}.bias"] = ((c,), ("normal", 0.0, 0.1))
        if bn:
            spec[f"{key}.running_mean"] = ((c,), ("normal", 0.0, 0.2))
            spec[f"{key}.running_var"] = ((c,), ("lognormal", 1.0, 0.3))

    def bias(key, c):
        spec[key] = ((c,), ("normal", 0.0, 0.02))

    hm = "transformer.embeddings.hybrid_model"
    cin0 = m.get("in_channels", 3)
    w(f"{hm}.root.conv.weight", (64, cin0, 7, 7), cin0 * 49)
    affine(f"{hm}.root.gn", 64)
    for key, cin, cout, cmid, stride in _stages():
        w(f"{key}.conv1.weight", (cmid, cin, 1, 1), cin)
        affine(f"{key}.gn1", cmid)
        w(f"{key}.conv2.weight", (cmid, cmid, 3, 3), cmid * 9)
        affine(f"{key}.gn2", cmid)
        w(f"{key}.conv3.weight", (cout, cmid, 1, 1), cmid)
        affine(f"{key}.gn3", cout)
        if stride != 1 or cin != cout:
            w(f"{key}.downsample.weight", (cout, cin, 1, 1), cin)
            affine(f"{key}.gn_proj", cout)
    emb = "transformer.embeddings"
    w(f"{emb}.patch_embeddings.weight", (HIDDEN, 1024, 1, 1), 1024, gain=1.0)
    bias(f"{emb}.patch_embeddings.bias", HIDDEN)
    spec[f"{emb}.position_embeddings"] = ((1, (height // 16) * (width // 16), HIDDEN), ("normal", 0.0, 0.5))
    for i in range(LAYERS):
        lay = f"transformer.encoder.layer.{i}"
        affine(f"{lay}.attention_norm", HIDDEN)
        for n in ("query", "key", "value", "out"):
            w(f"{lay}.attn.{n}.weight", (HIDDEN, HIDDEN), HIDDEN, gain=1.0)
            bias(f"{lay}.attn.{n}.bias", HIDDEN)
        affine(f"{lay}.ffn_norm", HIDDEN)
        w(f"{lay}.ffn.fc1.weight", (MLP, HIDDEN), HIDDEN, gain=1.0)
        bias(f"{lay}.ffn.fc1.bias", MLP)
        w(f"{lay}.ffn.fc2.weight", (HIDDEN, MLP), MLP, gain=1.0)
        bias(f"{lay}.ffn.fc2.bias", HIDDEN)
    affine("transformer.encoder.encoder_norm", HIDDEN)
    w("decoder.conv_more.0.weight", (HEAD_CHANNELS, HIDDEN, 3, 3), HIDDEN * 9)
    affine("decoder.conv_more.1", HEAD_CHANNELS, bn=True)
    skips = (512, 256, 64, 0)
    for i, (cin, cout, skip) in enumerate(zip((HEAD_CHANNELS,) + DECODER[:-1], DECODER, skips)):
        blk = f"decoder.blocks.{i}"
        w(f"{blk}.conv1.0.weight", (cout, cin + skip, 3, 3), (cin + skip) * 9)
        affine(f"{blk}.conv1.1", cout, bn=True)
        w(f"{blk}.conv2.0.weight", (cout, cout, 3, 3), cout * 9)
        affine(f"{blk}.conv2.1", cout, bn=True)
    n_out = m.get("out_channels", 1)
    w("segmentation_head.0.weight", (n_out, DECODER[-1], 3, 3), DECODER[-1] * 9, gain=1.0)
    bias("segmentation_head.0.bias", n_out)
    return spec


class Model:
    """The eval forward over the state dict ``sd`` (float32 tensors)."""

    def __init__(self, config, sd, train=False, precision=None, checkpoint=False):
        if train:
            raise NotImplementedError("the TransUNet reference serves only")
        self.sd, self.p = sd, Precision(precision)
        self.norms = Norms(sd, False)

    def _std_conv(self, x, key, stride=1, padding=0):
        wt = self.sd[f"{key}.weight"]
        var, mean = torch.var_mean(wt, dim=(1, 2, 3), keepdim=True, correction=0)
        return self.p.conv(x, (wt - mean) / torch.sqrt(var + 1e-5), None, stride, padding)

    def _gn(self, x, key, groups, eps):
        return F.group_norm(x, groups, self.sd[f"{key}.weight"], self.sd[f"{key}.bias"], eps)

    def _ln(self, x, key):
        return F.layer_norm(x, (x.shape[-1],), self.sd[f"{key}.weight"], self.sd[f"{key}.bias"], 1e-6)

    def _lin(self, x, key):
        return self.p.linear(x, self.sd[f"{key}.weight"], self.sd[f"{key}.bias"])

    def _unit(self, x, key, cin, cout, stride):
        residual = x
        if stride != 1 or cin != cout:
            residual = self._gn(self._std_conv(x, f"{key}.downsample", stride), f"{key}.gn_proj", cout, 1e-5)
        y = F.relu(self._gn(self._std_conv(x, f"{key}.conv1"), f"{key}.gn1", 32, 1e-6))
        y = F.relu(self._gn(self._std_conv(y, f"{key}.conv2", stride, 1), f"{key}.gn2", 32, 1e-6))
        y = self._gn(self._std_conv(y, f"{key}.conv3"), f"{key}.gn3", 32, 1e-6)
        return F.relu(residual + y)

    def _attention(self, x, lay):
        b, n, e = x.shape
        hd = e // HEADS

        def heads(t):
            return t.view(b, n, HEADS, hd).transpose(1, 2)

        q, k, v = (heads(self._lin(x, f"{lay}.attn.{name}")) for name in ("query", "key", "value"))
        s = self.p.matmul(q, k.transpose(2, 3)) / hd ** 0.5
        o = self.p.matmul(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(b, n, e)
        return self._lin(o, f"{lay}.attn.out")

    def _conv_bn_relu(self, x, key):
        return F.relu(self.norms(self.p.conv(x, self.sd[f"{key}.0.weight"], None, 1, 1), f"{key}.1"))

    def __call__(self, x):
        """Normalised float32 NCHW images [B,3,H,W] -> logits [B, out_channels, H, W]."""
        hm = "transformer.embeddings.hybrid_model"
        root = F.relu(self._gn(self._std_conv(x, f"{hm}.root.conv", 2, 3), f"{hm}.root.gn", 32, 1e-6))
        h = F.max_pool2d(root, 3, 2, 1)
        stage_out = {}
        for key, cin, cout, _, stride in _stages():
            h = self._unit(h, key, cin, cout, stride)
            stage_out[key.split(".")[-2]] = h
        features = [stage_out["block2"], stage_out["block1"], root]
        emb = "transformer.embeddings"
        t = self.p.conv(h, self.sd[f"{emb}.patch_embeddings.weight"], self.sd[f"{emb}.patch_embeddings.bias"])
        t = t.flatten(2).transpose(1, 2) + self.sd[f"{emb}.position_embeddings"]
        for i in range(LAYERS):
            lay = f"transformer.encoder.layer.{i}"
            t = self._attention(self._ln(t, f"{lay}.attention_norm"), lay) + t
            y = F.gelu(self._lin(self._ln(t, f"{lay}.ffn_norm"), f"{lay}.ffn.fc1"))
            t = self._lin(y, f"{lay}.ffn.fc2") + t
        t = self._ln(t, "transformer.encoder.encoder_norm")
        b, n, e = t.shape
        y = self._conv_bn_relu(t.transpose(1, 2).reshape(b, e, *h.shape[2:]), "decoder.conv_more")
        for i in range(len(DECODER)):
            y = F.interpolate(y, scale_factor=2, mode="bilinear", align_corners=True)
            if i < len(features):
                y = torch.cat([y, features[i]], 1)
            y = self._conv_bn_relu(self._conv_bn_relu(y, f"decoder.blocks.{i}.conv1"), f"decoder.blocks.{i}.conv2")
        return self.p.conv(y, self.sd["segmentation_head.0.weight"], self.sd["segmentation_head.0.bias"], 1, 1)
