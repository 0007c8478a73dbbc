"""Int8 serving for ViT-seg's ViT-B encoder (counterpart of dfc_sa_unet_tpu/infer/quant_vit.py).

The same post-training quantization as ``infer/quant.py``: per-out-channel
symmetric int8 weights of the four linears of every post-norm encoder layer
(the packed qkv projection, the attention's output projection, fc1, fc2),
per-tensor static activation scales, each quantized linear an
``s8_matmul`` (``torch._int_mm``) with one f32 epilogue y * (s_x * s_w) +
bias [-> exact GELU].  Attention (the ``fused_mha`` kernel on the packed qkv,
12 launches a forward at ViT-B), the LayerNorms (f32, eps 1e-5), the
residual adds, the patch embedding and the segmentation head stay in the
compute dtype / f32; the head's BatchNorms are folded into its
ConvTranspose(k4, s2, p1) weights.  With ``int8_ops={}`` this is the fp
engine, numerically the port's ViT-seg module.

Takes normalised NCHW images (channels_last) of ``img_dim`` x ``img_dim``,
as the module does, and returns f32 NCHW logits, as the JAX engine does.
Under a band of rows (row sharding, parallel/rows.py) it takes the band's
rows, as the module does: the band's patches, the token map gathered over the
spatial group, the encoder whole, the band's token rows into the head (whose
transposed convs read one halo row each side).
"""

from typing import Any, Iterable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dfc_sa_unet_torch.infer.quant import Calibrated, quantize_act, quantize_weight, range_tap
from dfc_sa_unet_torch.models.vit_seg import gelu, map_from_tokens, tokens_from_map
from dfc_sa_unet_torch.ops.conv_s8 import s8_matmul
from dfc_sa_unet_torch.ops.mha import fused_mha
from dfc_sa_unet_torch.ops.resize import resize_bilinear
from dfc_sa_unet_torch.parallel import rows
from dfc_sa_unet_torch.utils.device import resolve_device

VIT_OPS = frozenset({"qkv", "out", "fc1", "fc2"})
_KEY_OF = {"qkv": "in_w", "out": "out_w", "fc1": "w1", "fc2": "w2"}


def layernorm(x, weight, bias, eps):
    """LayerNorm over the last dimension in f32, returning x's dtype (nn/layers.py::LayerNorm)."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(x.dtype)


def dense(x, weight, bias, dtype):
    """A linear layer's numerics (nn/layers.py::Dense): operands in ``dtype``, the f32 bias added
    before the one cast to ``dtype``.  ``weight`` is [out, in] in ``dtype``."""
    return (F.linear(x.to(dtype), weight) + bias).to(dtype)


def dense_s8(x, w8, w_scale, x_scale, bias):
    """The quantized linear: x quantized with its static scale, s8 x s8 -> s32, then the f32
    epilogue acc * (x_scale * w_scale) + bias.  Returns f32 (callers apply GELU and the cast)."""
    return s8_matmul(quantize_act(x, x_scale), w8, x_scale * w_scale, bias)


def select_ops(int8_ops, num_layers, all_ops):
    """{layer: op-set} from "auto" (every op of every layer), an op iterable for every layer or a
    {layer: ops} mapping; an unknown layer or op raises."""
    if int8_ops == "auto":
        sel = {i: all_ops for i in range(num_layers)}
    elif isinstance(int8_ops, Mapping):
        sel = {int(i): frozenset(ops) for i, ops in int8_ops.items() if ops}
    else:
        ops = frozenset(int8_ops)
        sel = {i: ops for i in range(num_layers)} if ops else {}
    bad = [i for i in sel if not 0 <= i < num_layers] + [o for ops in sel.values() for o in ops if o not in all_ops]
    if bad:
        raise ValueError(f"unknown layers/ops: {bad}")
    return sel


class Int8ViTEngine(Calibrated):
    """Int8 serving for 'VisionTransformerSegmentation'.

    ``weights``: the port module's state dict (or the module).  ``int8_ops``: "auto" (all four
    linears of every layer), an op iterable applied to every layer, or a {layer: ops} mapping;
    ``{}`` serves fp.  ``act_scales`` maps ``f"{layer}.{x|attn|ln1|gelu}"`` to a float, or is
    "timing"; without it ``calib_batches`` calibrate them (see ``Calibrated``).
    """

    def __init__(self, config: Mapping[str, Any], weights, dtype=torch.bfloat16, device=None, int8_ops="auto",
                 act_scales=None, calib_batches: Optional[Iterable] = None,
                 calib_percentile: Optional[float] = None, holdout_batch=None):
        m = config.get("model", config)
        if m.get("name") != "VisionTransformerSegmentation":
            raise ValueError(f"Int8ViTEngine serves VisionTransformerSegmentation, got {m.get('name')!r}")
        self.device = resolve_device(device)
        self.dtype = dt = dtype
        self.img_dim = m.get("img_dim", 224)
        self.patch_dim = m.get("patch_dim", 16)
        self.num_heads = m.get("num_heads", 12)
        self.num_layers = m.get("num_layers", 12)
        if isinstance(weights, nn.Module):
            weights = weights.state_dict()
        sd = {k: v.detach().to(self.device, torch.float32) for k, v in weights.items()
              if not k.endswith("num_batches_tracked")}

        self.patch_w, self.patch_b = sd["patch_embed.proj.weight"].to(dt), sd["patch_embed.proj.bias"]
        self.pos = sd["pos_embed"]
        f32_layers, self.layers = [], []
        for i in range(self.num_layers):
            p = f"transformer_encoder.layers.{i}."
            f = {"in_w": sd[p + "self_attn.in_proj_weight"], "out_w": sd[p + "self_attn.out_proj.weight"],
                 "w1": sd[p + "linear1.weight"], "w2": sd[p + "linear2.weight"]}
            f32_layers.append(f)
            self.layers.append({
                **{k: w.to(dt) for k, w in f.items()},
                "in_b": sd[p + "self_attn.in_proj_bias"], "out_b": sd[p + "self_attn.out_proj.bias"],
                "b1": sd[p + "linear1.bias"], "b2": sd[p + "linear2.bias"],
                "n1": (sd[p + "norm1.weight"], sd[p + "norm1.bias"]),
                "n2": (sd[p + "norm2.weight"], sd[p + "norm2.bias"]),
            })

        # the head: ConvTranspose(k4 s2 p1) + BatchNorm (folded) + ReLU stages, then the 1x1 conv.
        # A ConvTranspose weight is [Cin, Cout, kh, kw]: the fold scales dim 1.
        self.head = []
        i = 0
        while f"segmentation_head.{3 * i + 1}.running_mean" in sd:
            ct, bn = f"segmentation_head.{3 * i}.", f"segmentation_head.{3 * i + 1}."
            a = sd[bn + "weight"] / torch.sqrt(sd[bn + "running_var"] + 1e-5)
            w = sd[ct + "weight"] * a.view(1, -1, 1, 1)
            b = (sd[ct + "bias"] - sd[bn + "running_mean"]) * a + sd[bn + "bias"]
            self.head.append((w.to(dt), b))
            i += 1
        fin = f"segmentation_head.{3 * i}."
        self.final_w, self.final_b = sd[fin + "weight"].to(dt), sd[fin + "bias"]

        self.int8_ops = select_ops(int8_ops, self.num_layers, VIT_OPS)
        self.qlayers = {i: {op: quantize_weight(f32_layers[i][_KEY_OF[op]]) for op in ops}
                        for i, ops in self.int8_ops.items()}
        self._init_calibration(calib_percentile, holdout_batch)
        need = {"qkv": "x", "out": "attn", "fc1": "ln1", "fc2": "gelu"}
        self._set_act_scales(act_scales, calib_batches,
                             [f"{i}.{t}" for i in self.int8_ops for t in ("x", "attn", "ln1", "gelu")],
                             [f"{i}.{need[o]}" for i, ops in self.int8_ops.items() for o in sorted(ops)],
                             "Int8ViTEngine")

    @property
    def band_stride(self) -> int:
        """The image rows of one token row: the family's band rule (parallel/rows.py)."""
        return self.patch_dim

    def _tap(self, ranges, key, t):
        range_tap(ranges, key, t, self.calib_percentile)

    def _layer(self, i, x, ranges=None):
        """One post-norm encoder layer on the f32 residual stream.  With ``ranges`` (calibration)
        the fp math runs and the four quantization points are recorded."""
        d, dt = self.layers[i], self.dtype
        ops = frozenset() if ranges is not None else self.int8_ops.get(i, frozenset())
        q = self.qlayers.get(i, {})

        self._tap(ranges, f"{i}.x", x)
        if "qkv" in ops:
            qkv = dense_s8(x, *q["qkv"], self.act_scales[f"{i}.x"], d["in_b"])
        else:
            qkv = F.linear(x.to(dt), d["in_w"]) + d["in_b"]
        a = fused_mha(qkv.to(dt), self.num_heads)
        self._tap(ranges, f"{i}.attn", a)
        if "out" in ops:
            sa = dense_s8(a, *q["out"], self.act_scales[f"{i}.attn"], d["out_b"]).to(dt)
        else:
            sa = dense(a, d["out_w"], d["out_b"], dt)
        x = layernorm(x + sa, *d["n1"], 1e-5)
        self._tap(ranges, f"{i}.ln1", x)
        if "fc1" in ops:
            h = F.gelu(dense_s8(x, *q["fc1"], self.act_scales[f"{i}.ln1"], d["b1"])).to(dt)
        else:
            h = gelu(dense(x, d["w1"], d["b1"], dt))
        self._tap(ranges, f"{i}.gelu", h)
        if "fc2" in ops:
            h = dense_s8(h, *q["fc2"], self.act_scales[f"{i}.gelu"], d["b2"]).to(dt)
        else:
            h = dense(h, d["w2"], d["b2"], dt)
        return layernorm(x + h, *d["n2"], 1e-5)

    def _fwd(self, x, ranges=None):
        """The one forward: serving (``ranges`` None) and calibration (a dict) share it."""
        dt = self.dtype
        x = x.to(self.device, dt, memory_format=torch.channels_last)
        h, w = x.shape[2:]
        band = rows.current()
        height = h if band is None else band.level(h)[0]
        if (height, w) != (self.img_dim, self.img_dim):
            raise ValueError(f"input image size ({height}x{w}) doesn't match the model's "
                             f"({self.img_dim}x{self.img_dim})")
        y = (F.conv2d(x, self.patch_w, stride=self.patch_dim) + self.patch_b.view(-1, 1, 1)).to(dt)
        # + pos promotes to f32, as in the module: the residual stream stays f32
        y = tokens_from_map(y if band is None else rows.all_gather_rows(y)) + self.pos
        for i in range(self.num_layers):
            y = self._layer(i, y, ranges)
        feat = self.img_dim // self.patch_dim
        y = map_from_tokens(y.to(dt), feat, feat)
        if band is not None:
            y = rows.band_rows(y)
        for k, b in self.head:
            z = rows.conv_transpose(y, k, 2, 1)
            y = torch.relu(z.float() + b.view(-1, 1, 1)).to(dt)
        logits = F.conv2d(y, self.final_w).float() + self.final_b.view(-1, 1, 1)
        return resize_bilinear(logits, (h, w), align_corners=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._fwd(x)

    __call__ = forward
