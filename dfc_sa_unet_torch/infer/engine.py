"""Serving engine for the DFC-SA U-Net (counterpart of dfc_sa_unet_tpu/infer/engine.py).

Numerically the module's eval forward, built for serving:

* every Conv+BatchNorm pair is folded into one conv (eval-mode BN is a
  per-channel affine: W' = W*a, b' = (b - mean)*a + beta);
* activations stay in the compute dtype end to end;
* the attention core always goes through ``ops/pooled_attention`` (the
  CUDA kernel on the card), and its epilogue (the upsample to the block's
  size, gamma and the residual add) through ``ops/lsa_epilogue`` (one CUDA
  pass on the card, where torch ran six);
* ``tail_kernel_levels`` picks the blocks whose whole tail (3x3 conv,
  gate, fusion, residual) runs as one CUDA kernel (``ops/dfc_tail``), as
  ``pallas_conv_levels`` did; ``"auto"`` is the same 7 levels;
* ``conv_kernel_levels`` picks the blocks whose local branch runs the
  same kernel's 3x3 conv mainloop on its own (``conv3x3_bn_relu``);
  ``"auto"`` is the two blocks outside the "auto" tail set (down1, whose
  Cin = 3, and the bottleneck, whose C = 1024 is beyond the tail kernel).

Both take ``None``, a set of block names or ``"auto"``, and must not
overlap.  A block in neither set runs on cuDNN convs and torch ops.

``_fwd(x, ranges)`` is the one forward: with a dict ``ranges`` it records the
int8 quantization points of every block (``{name}.x``, the block's input;
``{name}.c2``, the concat [local|a]; ``{name}.c3``, [fused|local|a]) through
``quant.range_tap``, and every block then runs its tail as torch ops, since
the tail kernel never materialises the two concats (the JAX engine's taps,
dfc_sa_unet_tpu/infer/engine.py:179-262).  Without ``ranges`` nothing changes.

Takes normalised NCHW activations (channels_last) like the module and
returns NCHW logits in the compute dtype.

Under a band of rows (row sharding, parallel/rows.py) every 3x3 conv reads
its neighbours' halo rows: the tail and conv3x3 kernels take them as their
``top`` and ``bottom`` rows (None at the image's edge), the cuDNN convs as two
more rows at padding (0, 1); the attention's pool is the whole image's
(``parallel.rows``), its epilogue takes the band's rows of the whole image's
upsample, the max pools are the band's own.

Under a ``torch.profiler`` session each block is two timed spans (``utils/profiling.py``),
``engine.attn_branch`` (the attention branch) and ``engine.local_tail`` (the tail kernel, or the
3x3 conv and the tail as torch ops), and what lies between the blocks is ``engine.between`` (each
max pool, each conv-transpose with its resize and concat, the final conv): nine of each a forward,
the int8 engine's (``infer/quant.py``) too.
"""

from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from dfc_sa_unet_torch.models.blocks import nchw, nhwc
from dfc_sa_unet_torch.ops.convt import conv_transpose_2x2
from dfc_sa_unet_torch.ops.dfc_tail import conv3x3_bn_relu, dfc_tail
from dfc_sa_unet_torch.ops.lsa_epilogue import lsa_epilogue
from dfc_sa_unet_torch.ops.pooled_attention import pooled_attention
from dfc_sa_unet_torch.ops.pooling import adaptive_avg_pool, max_pool
from dfc_sa_unet_torch.ops.resize import resize_bilinear
from dfc_sa_unet_torch.parallel import rows
from dfc_sa_unet_torch.utils.device import resolve_device
from dfc_sa_unet_torch.utils.profiling import span

BLOCKS = ("down1", "down2", "down3", "down4", "bottleneck",
          "up_conv4", "up_conv3", "up_conv2", "up_conv1")
AUTO_TAIL_LEVELS = frozenset({"down2", "down3", "down4", "up_conv4", "up_conv3", "up_conv2", "up_conv1"})
AUTO_CONV_LEVELS = frozenset(BLOCKS) - AUTO_TAIL_LEVELS


def fold_conv_bn(weight, bias, bn_weight, bn_bias, mean, var, eps: float = 1e-5):
    """Fold eval-mode BatchNorm into the preceding conv: OIHW weight, bias."""
    a = bn_weight / torch.sqrt(var + eps)
    w = weight * a.view(-1, *([1] * (weight.dim() - 1)))
    b = ((bias if bias is not None else 0.0) - mean) * a + bn_bias
    return w, b


def _levels(levels, auto):
    if levels == "auto":
        return set(auto)
    levels = set(levels or ())
    unknown = levels - set(BLOCKS)
    if unknown:
        raise ValueError(f"unknown block names {sorted(unknown)}; blocks are {BLOCKS}")
    return levels


def fold_block(sd, name):
    """The f32 weights of block ``name`` of a state dict with BatchNorm folded in (OIHW kernels, f32
    biases): "conv", "attn0", "kg", "kf" as (kernel, bias), "kr" the residual 1x1 kernel with
    res_scale folded in (None for the identity residual, whose scale is "res_scale"), "lsa" the
    attention's query / key / value (kernel, bias), "gamma" its scale."""
    def p(key):
        return sd[f"{name}.{key}"]

    def fold(conv, bn):
        return fold_conv_bn(p(f"{conv}.weight"), p(f"{conv}.bias"), p(f"{bn}.weight"),
                            p(f"{bn}.bias"), p(f"{bn}.running_mean"), p(f"{bn}.running_var"))

    res_scale = p("res_scale")
    lsa = "attn_branch.3"
    f = {"conv": fold("conv_branch.0", "conv_branch.1"), "attn0": fold("attn_branch.0", "attn_branch.1"),
         "kg": fold("gate.0", "gate.1"), "kf": fold("fusion_conv.0", "fusion_conv.1"), "res_scale": res_scale,
         "kr": p("residual_conv.weight") * res_scale if f"{name}.residual_conv.weight" in sd else None,
         "lsa": {key: (p(f"{lsa}.{key}_conv.weight"), p(f"{lsa}.{key}_conv.bias"))
                 for key in ("query", "key", "value")}, "gamma": p(f"{lsa}.gamma")}
    return f


def _conv(x, weight, bias, padding=0):
    """Folded conv: emitted in x's dtype, f32 bias added before the cast."""
    return (F.conv2d(x, weight, padding=padding) + bias.view(-1, 1, 1)).to(x.dtype)


class DFCEngine:
    """Folded inference for UNetDFCSA(Res).  ``weights`` is a state dict with
    the reference keys (or a module holding one)."""

    def __init__(self, config: Mapping[str, Any], weights, dtype=torch.bfloat16, device=None,
                 tail_kernel_levels=None, conv_kernel_levels=None):
        m = config.get("model", config)
        if m["name"] != "DFC-SA-Res-Block":
            raise NotImplementedError(f"DFCEngine serves DFC-SA-Res-Block, not {m['name']!r}")
        self.device = resolve_device(device)
        self.dtype = dtype
        self.pool_size = m.get("pool_size", 8)
        self.tail_kernel_levels = _levels(tail_kernel_levels, AUTO_TAIL_LEVELS)
        self.conv_kernel_levels = _levels(conv_kernel_levels, AUTO_CONV_LEVELS)
        both = self.tail_kernel_levels & self.conv_kernel_levels
        if both:
            raise ValueError(f"blocks {sorted(both)} are in both tail_kernel_levels and conv_kernel_levels")
        if isinstance(weights, nn.Module):
            weights = weights.state_dict()
        # folded on the CPU, whose sqrt is correctly rounded (CUDA's reads an ulp off in places): the folded
        # weights, and the int8 engine's s8 weights and scales from them, are then the same on every device
        sd = {k: v.detach().to("cpu", torch.float32) for k, v in weights.items()
              if not k.endswith("num_batches_tracked")}
        self.blocks = {name: self._fold_block(sd, name) for name in BLOCKS}
        dev = self.device
        self.ups = {f"up{i}": (sd[f"up{i}.weight"].to(dev, dtype), sd[f"up{i}.bias"].to(dev)) for i in range(1, 5)}
        self.final = (sd["final_conv.weight"].to(dev, dtype), sd["final_conv.bias"].to(dev))

    # ------------------------------------------------------------- folding

    def _fold_block(self, sd, name):
        """Block ``name``'s weights in the compute dtype and the kernels' layouts."""
        return self._cast_block(fold_block(sd, name))

    def _cast_block(self, f):
        """The folded f32 weights ``f`` on the engine's device, the kernels in the compute dtype."""
        dev, dt = self.device, self.dtype

        def w(t):
            return t.to(dev, dt)

        def b(t):
            return t.to(dev)

        kc, kg, kf = f["conv"][0], f["kg"][0], f["kf"][0]
        d = {
            "conv": (w(kc), b(f["conv"][1])), "attn0": (w(f["attn0"][0]), b(f["attn0"][1])),
            "kg": (w(kg), b(f["kg"][1])), "kf": (w(kf), b(f["kf"][1])),
            # the kernels' layout: HWIO 3x3 weight, [K, C] 1x1 weights
            "wc": w(kc.permute(2, 3, 1, 0).contiguous()),
            "wg": w(kg[:, :, 0, 0].t().contiguous()),
            "wf": w(kf[:, :, 0, 0].t().contiguous()),
        }
        kr = f["kr"]
        if kr is not None:
            d["kr"] = w(kr)
            d["wr"] = w(kr[:, :, 0, 0].t().contiguous())
        else:  # identity residual (Cin == C): eye * res_scale
            d["kr"] = None
            d["res_scale"] = b(f["res_scale"])
            d["wr"] = w(torch.eye(kc.shape[0]) * f["res_scale"])
        d["lsa"] = {key: (w(kk), b(bb)) for key, (kk, bb) in f["lsa"].items()}
        d["lsa"]["gamma"] = b(f["gamma"])
        return d

    # ------------------------------------------------------------- forward

    def _lsa(self, d, a):
        """The pooled attention of a (NCHW, channels_last) and its epilogue in one kernel: the
        upsample to a's rows, gamma and the residual add (``ops/lsa_epilogue``)."""
        p = self.pool_size
        pooled = adaptive_avg_pool(a, (p, p))
        q, k, v = (nhwc(_conv(pooled, *d[key])) for key in ("query", "key", "value"))
        band = rows.current()
        height, row0 = (a.shape[2], 0) if band is None else band.level(a.shape[2])
        return nchw(lsa_epilogue(nhwc(a), pooled_attention(q, k, v), d["gamma"], height, row0))

    @staticmethod
    def _halo(x):
        """Under a band of rows, x's halo rows as the kernels take them: (top, bottom), [B,W,C] each
        in x's dtype, None at the image's edge; (None, None) without a band."""
        band = rows.current()
        if band is None:
            return None, None
        top, bottom = rows.exchange_rows(x, band)
        b, c, _, w = x.shape
        return tuple(None if peer is None else nhwc(t).reshape(b, w, c)
                     for peer, t in ((band.prev, top), (band.next, bottom)))

    def _tap(self, ranges, key, t):
        """Calibration mode (``ranges`` a dict): record t's range under ``key`` (quant.range_tap)."""
        if ranges is not None:
            from dfc_sa_unet_torch.infer.quant import range_tap

            range_tap(ranges, key, t, getattr(self, "calib_percentile", None))

    # The block's steps, each written once; the int8 engine (infer/quant.py) overrides a step only to
    # run it in s8.  ``q`` is what its steps read beside x: None here and while calibrating.

    def _quantized(self, name, x, ranges):
        """What the int8 engine's steps of block ``name`` read beside its input x; None: every step fp."""
        return None

    def _a0(self, name, x, q=None):
        """The attention branch's 1x1 conv + BatchNorm (folded) + ReLU."""
        return torch.relu(_conv(x, *self.blocks[name]["attn0"]).float()).to(x.dtype)

    def _local(self, name, x, q=None):
        """The 3x3 conv + BatchNorm (folded) + ReLU: the conv kernel at ``conv_kernel_levels``, else a
        bias-free cuDNN conv in the compute dtype, then the +bc / ReLU epilogue."""
        d = self.blocks[name]
        if name in self.conv_kernel_levels:
            top, bottom = self._halo(x)
            return nchw(conv3x3_bn_relu(nhwc(x), d["wc"], d["conv"][1], top=top, bottom=bottom))
        y3 = rows.conv3x3(x, d["conv"][0]).to(x.dtype)
        return torch.relu(y3.float() + d["conv"][1].view(-1, 1, 1)).to(x.dtype)

    def _gate(self, name, combined, q=None):
        """The gate's 1x1 conv + BatchNorm + sigmoid of [local|a], in f32."""
        return torch.sigmoid(_conv(combined, *self.blocks[name]["kg"]).float())

    def _fuse(self, name, cat3, q=None):
        """The fusion's 1x1 conv + BatchNorm + ReLU of [fused|local|a], in f32."""
        return torch.relu(_conv(cat3, *self.blocks[name]["kf"]).float())

    def _residual(self, name, o, x, q=None):
        """o plus the residual of x: its 1x1 conv with res_scale folded in, or res_scale * x."""
        d = self.blocks[name]
        if d["kr"] is not None:
            return o + F.conv2d(x, d["kr"])
        return o + d["res_scale"] * x.float()

    def _tail_lax(self, name, local, a, x, q=None, ranges=None):
        """The module tail with BN folded: concat + 1x1 convs.  With ``ranges`` the int8
        quantization points c2 (combined) and c3 (cat3) are recorded."""
        combined = torch.cat([local, a], 1)
        self._tap(ranges, f"{name}.c2", combined)
        g = self._gate(name, combined, q)
        fused = (g * local.float() + (1.0 - g) * a.float()).to(local.dtype)
        cat3 = torch.cat([fused, combined], 1)
        self._tap(ranges, f"{name}.c3", cat3)
        return self._residual(name, self._fuse(name, cat3, q), x, q).to(local.dtype)

    def _block(self, name, x, ranges=None):
        """Block ``name``.  With ``ranges`` (calibration) its input x is recorded as ``{name}.x`` and
        the tail runs as torch ops, which materialise the concats the tail kernel keeps on chip."""
        d = self.blocks[name]
        self._tap(ranges, f"{name}.x", x)
        with span("engine.attn_branch", timed=True):
            q = self._quantized(name, x, ranges)
            a = self._lsa(d["lsa"], self._a0(name, x, q))
        with span("engine.local_tail", timed=True):
            if ranges is None and name in self.tail_kernel_levels:
                top, bottom = self._halo(x)
                out = dfc_tail(nhwc(x), nhwc(a), d["wc"], d["conv"][1], d["wg"], d["kg"][1],
                               d["wf"], d["kf"][1], d["wr"], top=top, bottom=bottom)
                return nchw(out)
            return self._tail_lax(name, self._local(name, x, q), a, x, q, ranges)

    def _fwd(self, x, ranges=None):
        """The one forward: serving (``ranges`` None) and int8 calibration (``ranges`` a dict that
        collects the quantization points' statistics) share it, so they cannot drift apart."""
        x = x.to(self.device, self.dtype, memory_format=torch.channels_last)
        skips = []
        h = x
        for i in range(1, 5):
            h = self._block(f"down{i}", h, ranges)
            skips.append(h)
            with span("engine.between", timed=True):
                h = max_pool(h, 2, 2)
        h = self._block("bottleneck", h, ranges)
        for i in range(4, 0, -1):
            skip = skips[i - 1]
            with span("engine.between", timed=True):
                h = conv_transpose_2x2(h, *self.ups[f"up{i}"])
                if h.shape[2:] != skip.shape[2:]:  # never under a band: its height is even at every level
                    assert rows.current() is None, f"the decoder's shape fix under a band of rows: {tuple(h.shape)}"
                    h = resize_bilinear(h, skip.shape[2:])
                h = torch.cat([h, skip], 1)
            h = self._block(f"up_conv{i}", h, ranges)
        with span("engine.between", timed=True):
            return _conv(h, *self.final)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._fwd(x)

    __call__ = forward
