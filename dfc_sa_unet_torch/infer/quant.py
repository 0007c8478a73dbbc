"""Int8 serving for the DFC-SA U-Net (counterpart of dfc_sa_unet_tpu/infer/quant.py).

Post-training quantization, as the JAX engine does it:

* weights: per-out-channel symmetric int8 of the BatchNorm-folded f32
  kernels (scale_w[c] = max|W[c]| / 127);
* activations: per-tensor symmetric int8 with STATIC scales calibrated on
  images (max |t|, or a percentile of |t|) -- no range pass at serving time;
* each quantized conv runs s8 x s8 -> s32, then one f32 epilogue
  acc * (s_x * s_w[c]) + bias [-> ReLU / sigmoid]: the 3x3 conv on the
  hand-written kernel ``ops/conv_s8.py::conv3x3_s8`` (PyTorch has no int8
  convolution on CUDA), the 1x1 convs on ``s8_matmul`` (``torch._int_mm``).
  Attention, the gate's mix and the residual stay in the compute dtype / f32;
* per block only three tensors are quantized: its input x (``{level}.x``,
  for the 3x3 conv, the attention's 1x1 conv and the residual), the concat
  [local|a] (``.c2``, the gate) and [fused|local|a] (``.c3``, the fusion).

``Int8DFCEngine`` is the port's ``DFCEngine`` with the chosen levels served
in int8; the others run as the fp engine, on the tail and conv kernels where
``tail_kernel_levels`` / ``conv_kernel_levels`` say so.  Calibration runs the
fp engine's own forward with range taps (``DFCEngine._fwd``) on the engine's
device.  ``int8_self_check`` compares the int8 engine with the fp
probabilities captured during calibration.

The level tables are the JAX package's (quant.py:57-80).  Its "auto" set was
measured on a TPU; on the H100 scripts/bench_torch_int8.py times each set.
"""

import math
from typing import Any, Iterable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from dfc_sa_unet_torch.infer.engine import (AUTO_CONV_LEVELS, AUTO_TAIL_LEVELS, BLOCKS, DFCEngine, _conv,
                                            _levels, fold_block)
from dfc_sa_unet_torch.models.blocks import nchw, nhwc
from dfc_sa_unet_torch.ops.conv_s8 import conv3x3_s8, pack_s8_taps, s8_matmul

_ALL_OPS = frozenset({"conv", "attn0", "gate", "fuse", "res"})
PROBE_INT8_OPS = {
    "down1": frozenset({"gate", "fuse"}),
    "down2": frozenset({"gate", "fuse"}),
    "down3": frozenset({"gate", "fuse"}),
    "down4": _ALL_OPS,
    "bottleneck": _ALL_OPS,
    "up_conv4": _ALL_OPS,
    "up_conv3": _ALL_OPS,
    "up_conv2": _ALL_OPS,
    "up_conv1": _ALL_OPS,
}
AUTO_INT8_OPS = {
    "down4": _ALL_OPS,
    "bottleneck": _ALL_OPS,
    "up_conv4": _ALL_OPS,
    "up_conv3": _ALL_OPS,
}
# the isolated full-level winners on the TPU, kept for A/B
AUTO_INT8_LEVELS = frozenset(
    {"down4", "bottleneck", "up_conv4", "up_conv3", "up_conv2", "up_conv1"}
)


def quantize_weight(kernel: torch.Tensor):
    """Per-out-channel symmetric int8 of a torch-layout weight (out channels first: OIHW, or
    [out, in]): returns (q s8, scale f32 [out]).  round(k / s), a division as in JAX."""
    k = kernel.float()
    m = k.abs().amax(dim=tuple(range(1, k.dim())))
    # a division by a tensor: CUDA divides by a Python scalar as a multiplication by its reciprocal
    s = torch.clamp(m / torch.full_like(m, 127.0), min=1e-12)
    q = torch.clamp(torch.round(k / s.view(-1, *([1] * (k.dim() - 1)))), -127, 127).to(torch.int8)
    return q, s


def quantize_act(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-tensor symmetric int8 with a static (calibrated) scale; rounds half to even, as jnp.round."""
    return torch.clamp(torch.round(x.float() * (1.0 / scale)), -127, 127).to(torch.int8)


def _percentile(a: torch.Tensor, q: float) -> float:
    """numpy's "linear" percentile (jnp.percentile's) of a flat tensor, from two order statistics
    (torch.kthvalue; torch.quantile refuses more than 2^24 elements).  The index q (n - 1) is taken in
    float64: numpy and jnp take it in the data's f32, which past 2^24 elements lands between other
    order statistics (a few 1e-6 of the value)."""
    n = a.numel()
    pos = q / 100.0 * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    t = pos - lo
    v_lo = float(torch.kthvalue(a, lo + 1).values)
    v_hi = float(torch.kthvalue(a, hi + 1).values) if hi != lo else v_lo
    d = v_hi - v_lo  # numpy's _lerp: from the nearer end
    return v_hi - d * (1.0 - t) if t >= 0.5 else v_lo + d * t


def range_tap(ranges, key, t: torch.Tensor, percentile=None):
    """Record tensor ``t``'s quantization range into ``ranges[key]``: max |t|, or with ``percentile``
    (e.g. 99.9) that percentile of |t|, robust to one outlier calibration image.  A no-op when
    ``ranges`` is None (serving)."""
    if ranges is None:
        return
    a = t.detach().float().abs().reshape(-1)
    ranges[key] = a.max() if percentile is None else _percentile(a, percentile)


def int8_self_check(engine, gate_flip: float = 5e-3, strict: bool = False, label: str = "int8"):
    """Serving-time sanity check of a calibrated int8 engine.

    Compares the quantized engine's probabilities with the fp probabilities captured during
    calibration, on the first calibration batch and, when the engine was given one, on the
    held-out batch; the gate applies to the worse of the two.  ``flip_rate`` is the fraction of
    pixels whose mask flips: 0.5-thresholded for a single-channel head, argmax disagreement for a
    multi-channel one (channels on dim 1).  Above ``gate_flip`` a warning prints, or RuntimeError
    is raised under ``strict``.  Returns {"flip_rate", "mean_abs_dprob"[, "holdout_flip_rate",
    "holdout_mean_abs_dprob"]}, or None for an engine built without calibration."""
    if getattr(engine, "calib_batch", None) is None:
        return None

    def compare(batch, fp):
        with torch.inference_mode():
            q = torch.sigmoid(engine(batch).float()).cpu().numpy()
        fp = fp.float().cpu().numpy() if torch.is_tensor(fp) else np.asarray(fp)
        if q.ndim >= 2 and q.shape[1] > 1:
            flip = float((np.argmax(q, axis=1) != np.argmax(fp, axis=1)).mean())
        else:
            flip = float(((q > 0.5) != (fp > 0.5)).mean())
        return flip, float(np.abs(q - fp).mean())

    flip, mad = compare(engine.calib_batch, engine.calib_fp_probs)
    metrics = {"flip_rate": flip, "mean_abs_dprob": mad}
    worst, where = flip, "calibration"
    if getattr(engine, "holdout_fp_probs", None) is not None:
        hflip, hmad = compare(engine.holdout_batch, engine.holdout_fp_probs)
        metrics["holdout_flip_rate"] = hflip
        metrics["holdout_mean_abs_dprob"] = hmad
        if hflip > worst:
            worst, where = hflip, "held-out"
    if worst > gate_flip:
        msg = (f"{label} self-check: quantized vs fp masks disagree on "
               f"{worst:.3%} of {where} pixels (gate {gate_flip:.3%}, "
               f"mean |dprob| {mad:.4f}) — the static scales may not fit "
               f"this checkpoint/data (try a percentile calibration, e.g. "
               f"--int8_percentile 99.9, or more calibration images)")
        if strict:
            raise RuntimeError(msg)
        print(f"WARNING: {msg}")
    return metrics


class Calibrated:
    """What the three int8 engines share: range calibration over fp forwards with taps
    (``_fwd(x, ranges)``), which keeps the first batch, its fp probabilities and the held-out
    batch's for ``int8_self_check``."""

    def _init_calibration(self, calib_percentile, holdout_batch):
        self.calib_percentile = calib_percentile
        self.calib_batch = self.calib_fp_probs = self.holdout_fp_probs = None
        self.holdout_batch = holdout_batch

    def collect_act_scales(self, calib_batches: Iterable) -> dict:
        """Static per-tensor scales over normalised NCHW batches (the contract of forward): max |t|,
        or the ctor's ``calib_percentile`` of |t|, over 127."""
        maxima: dict = {}
        n = 0
        with torch.inference_mode():
            for xb in calib_batches:
                ranges: dict = {}
                logits = self._fwd(xb, ranges)
                if n == 0:
                    self.calib_batch = xb
                    self.calib_fp_probs = torch.sigmoid(logits.float())
                for k, v in ranges.items():
                    maxima[k] = max(maxima.get(k, 0.0), float(v))
                n += 1
            if n == 0:
                raise ValueError("empty calibration stream")
            if self.holdout_batch is not None:  # the same fp forward
                self.holdout_fp_probs = torch.sigmoid(self._fwd(self.holdout_batch, {}).float())
        return {k: max(v, 1e-6) / 127.0 for k, v in maxima.items()}

    def _set_act_scales(self, act_scales, calib_batches, placeholders, needed, name):
        """act_scales as given, "timing" (placeholder scales of 0.05: the same work, garbage
        accuracy), or calibrated on ``calib_batches``; every key of ``needed`` must be there."""
        if act_scales == "timing":
            act_scales = {k: 0.05 for k in placeholders}
        if act_scales is None and calib_batches is None:
            if needed:
                raise ValueError(f"{name} needs act_scales or calib_batches")
            act_scales = {}
        if act_scales is None:
            act_scales = self.collect_act_scales(calib_batches)
        self.act_scales = {k: float(v) for k, v in act_scales.items()}
        missing = [k for k in needed if k not in self.act_scales]
        if missing:
            raise ValueError(f"act_scales missing entries: {missing}")


class Int8DFCEngine(Calibrated, DFCEngine):
    """DFCEngine with levels served in int8.

    ``int8_levels``: "auto" (down4, bottleneck, up_conv4, up_conv3, every op), an iterable of level
    names (every op of those levels) or a {level: op-set} mapping (ops of "conv", "attn0", "gate",
    "fuse", "res").  ``act_scales`` maps ``f"{level}.{x|c2|c3}"`` to a float, or is "timing"; without
    it ``calib_batches`` (normalised NCHW tensors, as forward takes) calibrate them here
    (``calib_percentile``: that percentile of |t| instead of max |t|; ``holdout_batch``: a batch for
    the self-check that the scales were not fit to).  ``tail_kernel_levels`` and
    ``conv_kernel_levels`` pick the fp levels' kernels as in DFCEngine; "auto" means DFCEngine's
    auto sets without the int8 levels, and an int8 level in either raises.  The s8 weights are
    quantized on the CPU from the f32 folded kernels (DFCEngine folds there), so they are the same on
    every device and in bf16 as in f32.
    """

    def __init__(self, config: Mapping[str, Any], weights, dtype=torch.bfloat16, device=None,
                 int8_levels="auto", act_scales=None, calib_batches: Optional[Iterable] = None,
                 calib_percentile: Optional[float] = None, holdout_batch=None,
                 tail_kernel_levels=None, conv_kernel_levels=None):
        if int8_levels == "auto":
            int8_ops = dict(AUTO_INT8_OPS)
        elif isinstance(int8_levels, Mapping):
            int8_ops = {n: frozenset(ops) for n, ops in int8_levels.items() if ops}
        else:
            int8_ops = {n: _ALL_OPS for n in int8_levels}
        unknown = sorted(set(int8_ops) - set(BLOCKS)) + sorted(
            o for ops in int8_ops.values() for o in ops if o not in _ALL_OPS)
        if unknown:
            raise ValueError(f"unknown levels: {unknown}")
        self.int8_ops = int8_ops
        self.int8_levels = set(int8_ops)
        self.qblocks = {}

        def fp_levels(levels, auto):
            if levels == "auto":
                return set(auto) - self.int8_levels
            both = _levels(levels, auto) & self.int8_levels
            if both:
                raise ValueError(f"blocks {sorted(both)} are int8 levels and kernel levels")
            return levels

        super().__init__(config, weights, dtype=dtype, device=device,
                         tail_kernel_levels=fp_levels(tail_kernel_levels, AUTO_TAIL_LEVELS),
                         conv_kernel_levels=fp_levels(conv_kernel_levels, AUTO_CONV_LEVELS))
        self._init_calibration(calib_percentile, holdout_batch)
        self._set_act_scales(act_scales, calib_batches,
                             [f"{n}.{t}" for n in int8_ops for t in ("x", "c2", "c3")],
                             [f"{n}.{t}" for n, ops in int8_ops.items() for t in self._scales_needed(ops)],
                             "Int8DFCEngine")

    @staticmethod
    def _scales_needed(ops):
        need = []
        if ops & {"conv", "attn0", "res"}:
            need.append("x")
        if "gate" in ops:
            need.append("c2")
        if "fuse" in ops:
            need.append("c3")
        return need

    def _fold_block(self, sd, name):
        f = fold_block(sd, name)
        ops = self.int8_ops.get(name)
        if ops:
            q = {}
            if "conv" in ops:
                w8, s = quantize_weight(f["conv"][0])
                q["conv"] = (pack_s8_taps(w8), s)
            for op, key in (("attn0", "attn0"), ("gate", "kg"), ("fuse", "kf")):
                if op in ops:
                    w8, s = quantize_weight(f[key][0])
                    q[key] = (w8[:, :, 0, 0].contiguous(), s)
            if "res" in ops and f["kr"] is not None:  # res_scale folded in
                w8, s = quantize_weight(f["kr"])
                q["kr"] = (w8[:, :, 0, 0].contiguous(), s)
            self.qblocks[name] = {key: (w8.to(self.device), s.to(self.device)) for key, (w8, s) in q.items()}
        return self._cast_block(f)

    def _x_branches(self, name, x):
        """What int8 level ``name`` computes from its input x alone: (x8, local, a0).  x8 is x
        quantized (None where no op reads it); local the 3x3 conv + BN (folded) + ReLU, on the s8
        kernel with its f32 epilogue or fp; a0 the attention branch's 1x1 conv + BN + ReLU, s8 or fp.
        Given the same x, the s8 ones are the same bits on any device."""
        d, q, ops, dt = self.blocks[name], self.qblocks[name], self.int8_ops[name], x.dtype
        x8 = sx = None
        if ops & {"conv", "attn0", "res"}:
            sx = self.act_scales[f"{name}.x"]
            x8 = quantize_act(nhwc(x), sx)
        if "conv" in ops:
            w8, s3 = q["conv"]
            local = nchw(conv3x3_s8(x8, w8, sx * s3, d["conv"][1], out_dtype=dt))
        else:
            y3 = F.conv2d(x, d["conv"][0], padding=1).to(dt)
            local = torch.relu(y3.float() + d["conv"][1].view(-1, 1, 1)).to(dt)
        if "attn0" in ops:
            wa, sa = q["attn0"]
            a0 = nchw(torch.relu(s8_matmul(x8, wa, sx * sa, d["attn0"][1])).to(dt))
        else:
            a0 = torch.relu(_conv(x, *d["attn0"]).float()).to(dt)
        return x8, local, a0

    def _block(self, name, x, ranges=None):
        ops = self.int8_ops.get(name)
        if ranges is not None or not ops:  # calibration runs the fp math (and its taps)
            return super()._block(name, x, ranges)
        d, q, dt = self.blocks[name], self.qblocks[name], x.dtype
        x8, local, a0 = self._x_branches(name, x)
        a = self._lsa(d["lsa"], a0)

        combined = torch.cat([local, a], 1)
        if "gate" in ops:
            sc2 = self.act_scales[f"{name}.c2"]
            wg, sg = q["kg"]
            g = nchw(torch.sigmoid(s8_matmul(quantize_act(nhwc(combined), sc2), wg, sc2 * sg, d["kg"][1])))
        else:
            g = torch.sigmoid(_conv(combined, *d["kg"]).float())
        fused = (g * local.float() + (1.0 - g) * a.float()).to(dt)

        cat3 = torch.cat([fused, combined], 1)
        if "fuse" in ops:
            sc3 = self.act_scales[f"{name}.c3"]
            wf, sf = q["kf"]
            o = nchw(torch.relu(s8_matmul(quantize_act(nhwc(cat3), sc3), wf, sc3 * sf, d["kf"][1])))
        else:
            o = torch.relu(_conv(cat3, *d["kf"]).float())

        if d["kr"] is None:
            o = o + d["res_scale"] * x.float()
        elif "res" in ops:
            wr, sr = q["kr"]
            o = o + nchw(s8_matmul(x8, wr, self.act_scales[f"{name}.x"] * sr))
        else:
            o = o + F.conv2d(x, d["kr"]).float()
        return o.to(dt)
