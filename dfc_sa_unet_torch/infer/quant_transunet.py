"""Int8 serving for TransUNet's ViT-B encoder (counterpart of
dfc_sa_unet_tpu/infer/quant_transunet.py).

The quantization of ``infer/quant_vit.py`` on TransUNet's twelve pre-norm
blocks: the separate query / key / value linears are packed into one
[3E, E] product at build (one quantize boundary instead of three), so
attention runs the packed ``fused_mha`` kernel (12 launches a forward at
ViT-B), not the module's ``fused_mha_sep``; the four linears of a block (qkv,
out, fc1, fc2) are ``s8_matmul`` products with one f32 epilogue.  The
LayerNorms (f32, eps 1e-6), the f32 residual stream, the hybrid ResNetV2
backbone and patch embedding, the DecoderCup and the head stay in the
compute dtype / f32 and run through the port's own TransUNet submodules, in
eval mode.  A single-channel input is repeated to 3 channels.  With
``int8_ops={}`` this is the fp engine, numerically the port's TransUNet.

Takes normalised NCHW images (channels_last) of ``img_dim`` x ``img_dim``
and returns NCHW logits in the compute dtype, as the module does.
"""

from typing import Any, Iterable, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from dfc_sa_unet_torch.infer.quant import Calibrated, quantize_weight, range_tap
from dfc_sa_unet_torch.infer.quant_vit import dense, dense_s8, layernorm, select_ops
from dfc_sa_unet_torch.models.transunet import TransUNet, get_r50_b16_config
from dfc_sa_unet_torch.models.vit_seg import gelu
from dfc_sa_unet_torch.ops.mha import fused_mha
from dfc_sa_unet_torch.utils.device import resolve_device

TRANSUNET_OPS = frozenset({"qkv", "out", "fc1", "fc2"})
# the scale key's suffix per quantized op: qkv reads the attention_norm output, out the attention
# output, fc1 the ffn_norm output, fc2 the (exact) GELU output
_NEED = {"qkv": "ln_a", "out": "attn", "fc1": "ln_f", "fc2": "gelu"}
_KEY_OF = {"qkv": "in_w", "out": "out_w", "fc1": "w1", "fc2": "w2"}


class Int8TransUNetEngine(Calibrated):
    """Int8 serving for 'TransformerUNet' / 'TransUNet'.

    ``weights``: the port module's state dict (or the module).  ``int8_ops`` as Int8ViTEngine's;
    ``act_scales`` maps ``f"{layer}.{ln_a|attn|ln_f|gelu}"`` to a float, or is "timing".
    ``vit_config`` overrides the R50-ViT-B/16 hyperparameters, which are otherwise derived from
    ``config`` as the factory does (``dataset.img_size`` sizes the model).
    """

    def __init__(self, config: Mapping[str, Any], weights, dtype=torch.bfloat16, device=None, int8_ops="auto",
                 act_scales=None, calib_batches: Optional[Iterable] = None,
                 vit_config: Optional[Mapping[str, Any]] = None, calib_percentile: Optional[float] = None,
                 holdout_batch=None):
        m = config.get("model", config)
        if m.get("name") not in ("TransformerUNet", "TransUNet"):
            raise ValueError(f"Int8TransUNetEngine serves TransformerUNet, got {m.get('name')!r}")
        self.device = resolve_device(device)
        self.dtype = dt = dtype
        img = config.get("dataset", {}).get("img_size", [224, 224])
        self.img_dim = img[0] if isinstance(img, (list, tuple)) else img
        if vit_config is None:
            vit_config = get_r50_b16_config()
            vit_config["n_classes"] = m.get("out_channels", 1)
            vit_config["patches_grid"] = (self.img_dim // 16, self.img_dim // 16)
        self.cfg = dict(vit_config)
        self.num_heads, self.num_layers = self.cfg["num_heads"], self.cfg["num_layers"]
        if isinstance(weights, nn.Module):
            weights = weights.state_dict()

        # the backbone and embeddings, the decoder and the head: the module's own, in eval mode
        with torch.device("meta"):  # no initialisation: the weights are assigned
            module = TransUNet(self.cfg, img_size=self.img_dim, num_classes=self.cfg["n_classes"], compute_dtype=dt)
        module.load_state_dict({k: v.detach() for k, v in weights.items()}, strict=True, assign=True)
        module = module.to(self.device, memory_format=torch.channels_last).eval()
        self.embeddings, self.decoder = module.transformer.embeddings, module.decoder
        self.segmentation_head = module.segmentation_head

        # the encoder blocks, q / k / v packed into one [3E, E] product
        sd = {k: v.detach().to(self.device, torch.float32) for k, v in weights.items()
              if k.startswith("transformer.encoder.")}
        f32_layers, self.layers = [], []
        for i in range(self.num_layers):
            p = f"transformer.encoder.layer.{i}."
            f = {"in_w": torch.cat([sd[p + f"attn.{n}.weight"] for n in ("query", "key", "value")]),
                 "out_w": sd[p + "attn.out.weight"], "w1": sd[p + "ffn.fc1.weight"], "w2": sd[p + "ffn.fc2.weight"]}
            f32_layers.append(f)
            self.layers.append({
                **{k: w.to(dt) for k, w in f.items()},
                "in_b": torch.cat([sd[p + f"attn.{n}.bias"] for n in ("query", "key", "value")]),
                "out_b": sd[p + "attn.out.bias"], "b1": sd[p + "ffn.fc1.bias"], "b2": sd[p + "ffn.fc2.bias"],
                "n1": (sd[p + "attention_norm.weight"], sd[p + "attention_norm.bias"]),
                "n2": (sd[p + "ffn_norm.weight"], sd[p + "ffn_norm.bias"]),
            })
        self.enc_norm = (sd["transformer.encoder.encoder_norm.weight"], sd["transformer.encoder.encoder_norm.bias"])

        self.int8_ops = select_ops(int8_ops, self.num_layers, TRANSUNET_OPS)
        self.qlayers = {i: {op: quantize_weight(f32_layers[i][_KEY_OF[op]]) for op in ops}
                        for i, ops in self.int8_ops.items()}
        self._init_calibration(calib_percentile, holdout_batch)
        self._set_act_scales(act_scales, calib_batches,
                             [f"{i}.{t}" for i in self.int8_ops for t in ("ln_a", "attn", "ln_f", "gelu")],
                             [f"{i}.{_NEED[o]}" for i, ops in self.int8_ops.items() for o in sorted(ops)],
                             "Int8TransUNetEngine")

    def _tap(self, ranges, key, t):
        range_tap(ranges, key, t, self.calib_percentile)

    def _layer(self, i, x, ranges=None):
        """One pre-norm block on the f32 residual stream.  With ``ranges`` (calibration) the fp math
        runs and the four quantization points are recorded."""
        d, dt = self.layers[i], self.dtype
        ops = frozenset() if ranges is not None else self.int8_ops.get(i, frozenset())
        q = self.qlayers.get(i, {})

        y = layernorm(x, *d["n1"], 1e-6)
        self._tap(ranges, f"{i}.ln_a", y)
        if "qkv" in ops:
            qkv = dense_s8(y, *q["qkv"], self.act_scales[f"{i}.ln_a"], d["in_b"])
        else:
            qkv = F.linear(y.to(dt), d["in_w"]) + d["in_b"]
        a = fused_mha(qkv.to(dt), self.num_heads)
        self._tap(ranges, f"{i}.attn", a)
        if "out" in ops:
            sa = dense_s8(a, *q["out"], self.act_scales[f"{i}.attn"], d["out_b"]).to(dt)
        else:
            sa = dense(a, d["out_w"], d["out_b"], dt)
        x = x + sa

        y = layernorm(x, *d["n2"], 1e-6)
        self._tap(ranges, f"{i}.ln_f", y)
        if "fc1" in ops:
            h = F.gelu(dense_s8(y, *q["fc1"], self.act_scales[f"{i}.ln_f"], d["b1"])).to(dt)
        else:
            h = gelu(dense(y, d["w1"], d["b1"], dt))
        self._tap(ranges, f"{i}.gelu", h)
        if "fc2" in ops:
            h = dense_s8(h, *q["fc2"], self.act_scales[f"{i}.gelu"], d["b2"]).to(dt)
        else:
            h = dense(h, d["w2"], d["b2"], dt)
        return x + h

    def _fwd(self, x, ranges=None):
        """The one forward: serving (``ranges`` None) and calibration (a dict) share it."""
        x = x.to(self.device, self.dtype, memory_format=torch.channels_last)
        if x.shape[1] == 1:
            x = x.repeat(1, 3, 1, 1)
        y, features = self.embeddings(x)
        for i in range(self.num_layers):
            y = self._layer(i, y, ranges)
        y = layernorm(y, *self.enc_norm, 1e-6)
        return self.segmentation_head(self.decoder(y, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._fwd(x)

    __call__ = forward
