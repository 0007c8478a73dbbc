"""Plain float32 reference of SegFormer-B5 (Xie et al., arXiv:2105.15203; the NVlabs code's
mmseg/models/backbones/mix_transformer.py ``mit_b5`` and mmseg/models/decode_heads/
segformer_head.py, as local_configs/segformer/B5/segformer.b5.1024x1024.city.160k.py builds them),
written over a state dict with that code's keys, for serving (eval mode).

* Mix Transformer, four stages of widths (64, 128, 320, 512), depths (3, 6, 40, 3), heads (1, 2, 5,
  8) of 64, spatial-reduction ratios (8, 4, 2, 1), MLP ratio 4, with q, k and v biases:
  an overlapping patch embedding (a 7x7 conv at stride 4 and padding 3, then 3x3 at stride 2 and
  padding 1; LayerNorm with torch's default eps 1e-5); blocks of x + attn(norm1(x)) and x +
  mlp(norm2(x)) (LayerNorm eps 1e-6); the attention's q = Linear(x), and where R > 1 keys and values
  from an R x R conv at stride R of the map and a LayerNorm (eps 1e-5), kv = Linear(.) split into k
  and v, softmax(q k^T * 64^-0.5) v by matmul, a projection; the Mix-FFN fc1 (to 4 C), a depthwise
  3x3 conv with bias, the exact GELU, fc2; each stage closed by a LayerNorm (eps 1e-6);
* the all-MLP head of width 768: each stage through a linear layer, resized bilinearly
  (align_corners=False) to the 1/4 map, concatenated as [c4, c3, c2, c1], a 1x1 conv without bias,
  BatchNorm (eps 1e-5, running statistics) and ReLU, a 1x1 conv with bias to the classes;
* the logits resized bilinearly (align_corners=False) to the input's size, as mmseg's
  ``encode_decode`` does.

Departures from the source, all of them:
* one output class (this repository's binary masks) where Cityscapes has 19;
* no dropout, drop path or the head's dropout (the source applies them in training only);
* the base head's ``conv_seg``, which SegFormer's forward never calls, is not in the state dict;
* sliding windows, padding and the inputs' normalisation are the serving path's, not this
  function's: it takes normalised images whose sides are multiples of 32.

Nothing of the program under test is imported: plain ``torch`` only.  The check computes it inside
``reference.plain.exact_f32`` (no TF32); ``precision`` rounds every product's operands
(``reference.plain.Precision``).
"""

import torch
import torch.nn.functional as F

from portbench.reference.plain import Norms, Precision

WIDTHS = {"embed_dims": (64, 128, 320, 512), "depths": (3, 6, 40, 3), "num_heads": (1, 2, 5, 8),
          "sr_ratios": (8, 4, 2, 1), "mlp_ratio": 4, "decoder_dim": 768}


def _widths(m):
    return {key: m.get(key, default) for key, default in WIDTHS.items()}


def state_spec(config) -> dict:
    """{key: (shape, draw)} of every parameter and BatchNorm statistic (the draws of
    dfc_sa_res_block.state_spec): linear layers and convolutions a variance-preserving spread (2 /
    fan-in before the ReLU, 1 elsewhere, half that on the branches that write into the residual
    stream: the attention's projection and fc2), biases a small one, LayerNorm and BatchNorm
    affines around 1 and 0, BatchNorm's running statistics drawn so that the norm has work."""
    m = config["model"]
    w = _widths(m)
    spec = {}

    def weight(key, shape, fan_in, gain=1.0):
        spec[f"{key}.weight"] = (shape, ("normal", 0.0, (gain / fan_in) ** 0.5))

    def bias(key, c):
        spec[f"{key}.bias"] = ((c,), ("normal", 0.0, 0.02))

    def affine(key, c):
        spec[f"{key}.weight"] = ((c,), ("normal", 1.0, 0.1))
        spec[f"{key}.bias"] = ((c,), ("normal", 0.0, 0.1))

    def linear(key, cin, cout, gain=1.0):
        weight(key, (cout, cin), cin, gain)
        bias(key, cout)

    cin = m.get("in_channels", 3)
    for i, (dim, depth, sr) in enumerate(zip(w["embed_dims"], w["depths"], w["sr_ratios"]), start=1):
        k = 7 if i == 1 else 3
        pe = f"backbone.patch_embed{i}"
        weight(f"{pe}.proj", (dim, cin, k, k), cin * k * k)
        bias(f"{pe}.proj", dim)
        affine(f"{pe}.norm", dim)
        hidden = dim * w["mlp_ratio"]
        for j in range(depth):
            blk = f"backbone.block{i}.{j}"
            affine(f"{blk}.norm1", dim)
            linear(f"{blk}.attn.q", dim, dim)
            linear(f"{blk}.attn.kv", dim, 2 * dim)
            linear(f"{blk}.attn.proj", dim, dim, gain=0.5)
            if sr > 1:
                weight(f"{blk}.attn.sr", (dim, dim, sr, sr), dim * sr * sr)
                bias(f"{blk}.attn.sr", dim)
                affine(f"{blk}.attn.norm", dim)
            affine(f"{blk}.norm2", dim)
            linear(f"{blk}.mlp.fc1", dim, hidden)
            weight(f"{blk}.mlp.dwconv.dwconv", (hidden, 1, 3, 3), 9)
            bias(f"{blk}.mlp.dwconv.dwconv", hidden)
            linear(f"{blk}.mlp.fc2", hidden, dim, gain=0.5)
        affine(f"backbone.norm{i}", dim)
        cin = dim
    d = w["decoder_dim"]
    for i, dim in enumerate(w["embed_dims"], start=1):
        linear(f"decode_head.linear_c{i}.proj", dim, d)
    stages = len(w["embed_dims"])
    weight("decode_head.linear_fuse.conv", (d, stages * d, 1, 1), stages * d, gain=2.0)
    affine("decode_head.linear_fuse.bn", d)
    spec["decode_head.linear_fuse.bn.running_mean"] = ((d,), ("normal", 0.0, 0.2))
    spec["decode_head.linear_fuse.bn.running_var"] = ((d,), ("lognormal", 1.0, 0.3))
    n_out = m.get("out_channels", 1)
    weight("decode_head.linear_pred", (n_out, d, 1, 1), d)
    bias("decode_head.linear_pred", n_out)
    return spec


class Model:
    """The eval forward over the state dict ``sd`` (float32 tensors)."""

    def __init__(self, config, sd, train=False, precision=None, checkpoint=False):
        if train:
            raise NotImplementedError("the SegFormer reference serves only")
        self.sd, self.p, self.w = sd, Precision(precision), _widths(config["model"])
        self.norms = Norms(sd, False)

    def _ln(self, x, key, eps):
        return F.layer_norm(x, (x.shape[-1],), self.sd[f"{key}.weight"], self.sd[f"{key}.bias"], eps)

    def _lin(self, x, key):
        return self.p.linear(x, self.sd[f"{key}.weight"], self.sd[f"{key}.bias"])

    def _patch_embed(self, x, i):
        key = f"backbone.patch_embed{i}"
        wt = self.sd[f"{key}.proj.weight"]
        x = self.p.conv(x, wt, self.sd[f"{key}.proj.bias"], 4 if i == 1 else 2, wt.shape[-1] // 2)
        _, _, h, w = x.shape
        return self._ln(x.flatten(2).transpose(1, 2), f"{key}.norm", 1e-5), h, w

    def _attention(self, x, key, heads, sr, h, w):
        b, n, c = x.shape
        hd = c // heads
        q = self._lin(x, f"{key}.q").reshape(b, n, heads, hd).permute(0, 2, 1, 3)
        if sr > 1:
            x_ = x.permute(0, 2, 1).reshape(b, c, h, w)
            x_ = self.p.conv(x_, self.sd[f"{key}.sr.weight"], self.sd[f"{key}.sr.bias"], sr)
            x_ = self._ln(x_.reshape(b, c, -1).permute(0, 2, 1), f"{key}.norm", 1e-5)
        else:
            x_ = x
        kv = self._lin(x_, f"{key}.kv").reshape(b, -1, 2, heads, hd).permute(2, 0, 3, 1, 4)
        k, v = kv[0], kv[1]
        attn = torch.softmax(self.p.matmul(q, k.transpose(-2, -1)) * hd ** -0.5, dim=-1)
        o = self.p.matmul(attn, v).transpose(1, 2).reshape(b, n, c)
        return self._lin(o, f"{key}.proj")

    def _mix_ffn(self, x, key, h, w):
        b, n, _ = x.shape
        y = self._lin(x, f"{key}.fc1")
        hidden = y.shape[-1]
        y = y.transpose(1, 2).reshape(b, hidden, h, w)
        dw = f"{key}.dwconv.dwconv"
        y = F.conv2d(self.p(y), self.p(self.sd[f"{dw}.weight"]), self.sd[f"{dw}.bias"], 1, 1, 1, hidden)
        return self._lin(F.gelu(y.flatten(2).transpose(1, 2)), f"{key}.fc2")

    def _mlp_map(self, x, key):
        """A stage's map through the head's linear layer, as a map."""
        b, _, h, w = x.shape
        return self._lin(x.flatten(2).transpose(1, 2), key).permute(0, 2, 1).reshape(b, -1, h, w)

    def __call__(self, x):
        """Normalised float32 NCHW images [B,3,H,W] -> logits [B, out_channels, H, W]."""
        w = self.w
        outs = []
        y = x
        for i, (depth, heads, sr) in enumerate(zip(w["depths"], w["num_heads"], w["sr_ratios"]), start=1):
            t, h, wd = self._patch_embed(y, i)
            for j in range(depth):
                blk = f"backbone.block{i}.{j}"
                t = t + self._attention(self._ln(t, f"{blk}.norm1", 1e-6), f"{blk}.attn", heads, sr, h, wd)
                t = t + self._mix_ffn(self._ln(t, f"{blk}.norm2", 1e-6), f"{blk}.mlp", h, wd)
            t = self._ln(t, f"backbone.norm{i}", 1e-6)
            y = t.reshape(t.shape[0], h, wd, -1).permute(0, 3, 1, 2).contiguous()
            outs.append(y)
        size = outs[0].shape[2:]
        ups = [self._mlp_map(outs[i - 1], f"decode_head.linear_c{i}.proj") for i in range(len(outs), 0, -1)]
        ups = [u if u.shape[2:] == size else F.interpolate(u, size=size, mode="bilinear", align_corners=False)
               for u in ups]
        y = self.p.conv(torch.cat(ups, 1), self.sd["decode_head.linear_fuse.conv.weight"])
        y = F.relu(self.norms(y, "decode_head.linear_fuse.bn"))
        y = self.p.conv(y, self.sd["decode_head.linear_pred.weight"], self.sd["decode_head.linear_pred.bias"])
        return F.interpolate(y, size=x.shape[2:], mode="bilinear", align_corners=False)
