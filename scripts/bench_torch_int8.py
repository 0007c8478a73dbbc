#!/usr/bin/env python3
"""The int8 3x3 conv kernel and the int8 flagship's level sets, on one GPU.

    python3 scripts/bench_torch_int8.py [--root DIR] [--batch 128] [--iters 5] [--seed 0]

First ``ops/conv_s8.py::conv3x3_s8`` at the four levels the int8 engine's "auto" set sends it
(``infer/quant.py::AUTO_INT8_OPS``: down4, bottleneck, up_conv4, up_conv3 at 224x224, B=128, bf16
out): held to its plain version bit for bit (after a launch on inputs of all +127 and -128), then
timed beside the plain version, the bf16 yardstick (what the bf16 engine runs at the same level:
cuDNN's bf16 conv with the bias and a ReLU, on channels_last views of bf16 tensors of the same
shapes) and the bound: the larger of the bytes of x8, w8, the scale, the bias and the bf16 output
once over 3.35 TB/s and the 2 * 9 Cin * Cout operations a pixel over 1979 TOP/s (dense s8).

Then the int8 flagship's forward (full width, seeded weights with BatchNorm statistics fitted to
16 images, bf16, B=128, placeholder "timing" scales: the same work as calibrated ones) for the
level sets "auto", each auto level alone and ``AUTO_INT8_LEVELS`` (the TPU's isolated winners),
each with the fp levels on the engine's kernels ("auto"), each beside the bf16 folded engine's
forward (``--engine``) in turns: engine, int8, int8, engine.  ``--root DIR`` imports
``dfc_sa_unet_torch`` from another checkout.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_S8_OPS = 1979e12      # dense int8 on the tensor cores
# (level, H, Cin, Cout): the int8 engine's auto levels at 224x224
LEVELS = [("down4", 28, 256, 512), ("bottleneck", 14, 512, 1024), ("up_conv4", 28, 1024, 512),
          ("up_conv3", 56, 512, 256)]
CONFIG = {"model": {"name": "DFC-SA-Res-Block", "in_channels": 3, "out_channels": 1,
                    "features": [64, 128, 256, 512], "pool_size": 8}}
IMG = 224


def timed(fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def inputs(b, h, w, cin, cout, gen):
    """x8 [B,H,W,Cin] and w8 [Cout, 9 Cin] s8, scale (~1 / (sx 127 sqrt(9 Cin))) and bias f32; seeded."""
    dev = gen.device
    x8 = torch.randint(-127, 128, (b, h, w, cin), generator=gen, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (cout, 9 * cin), generator=gen, device=dev, dtype=torch.int8)
    scale = (torch.rand(cout, generator=gen, device=dev) + 0.5) / (127.0 * 127.0 * (9 * cin) ** 0.5)
    return x8, w8, scale, torch.randn(cout, generator=gen, device=dev)


def yardstick(b, h, cin, cout, gen):
    """What the bf16 engine runs at the same shapes: cuDNN's bf16 conv + bias + ReLU, channels_last."""
    dev = gen.device
    x = torch.randn(b, cin, h, h, generator=gen, device=dev).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    k = (torch.randn(cout, cin, 3, 3, generator=gen, device=dev) * (9 * cin) ** -0.5).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    bias = torch.randn(cout, generator=gen, device=dev).to(torch.bfloat16)
    return lambda: F.relu(F.conv2d(x, k, bias, padding=1))


def work(b, h, cin, cout, out_bytes=2):
    """(bytes, operations) of one launch: x8, w8, scale and bias, the output in its type."""
    npix = b * h * h
    return npix * cin + 9 * cin * cout + 8 * cout + out_bytes * npix * cout, 2 * npix * cout * 9 * cin


def bound_ms(b, h, cin, cout):
    nbytes, ops = work(b, h, cin, cout)
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / PEAK_S8_OPS}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def check(ops, x8, w8, scale, bias, out_dtype=torch.bfloat16):
    """max |kernel - plain| after a launch on inputs of all +127 and -128 (stale shared memory that
    a wrong launch would read); raises unless it is 0."""
    ops.conv3x3_s8(torch.full_like(x8, 127), torch.full_like(w8, -128), scale, bias, out_dtype)
    got = ops.conv3x3_s8(x8, w8, scale, bias, out_dtype)
    want = ops.conv3x3_s8_plain(x8, w8, scale, bias, out_dtype)
    err = (got.float() - want.float()).abs().max().item()
    if err != 0 or got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"conv3x3_s8: kernel and plain version disagree: max abs err {err:.3e}")
    return err


def flagship_weights(seed, dev):
    """The flagship's seeded weights with BatchNorm statistics fitted to 16 seeded images."""
    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, init_random_

    model = init_random_(create_model(CONFIG, device="cpu"), torch.Generator().manual_seed(seed))
    model = model.to(dev, memory_format=torch.channels_last)
    images = np.random.default_rng(seed).integers(0, 256, (16, IMG, IMG, 3), dtype=np.uint8)
    with torch.inference_mode():
        calibrate_batch_stats_(model, normalize(torch.from_numpy(images).to(dev)).permute(0, 3, 1, 2))
    return model.state_dict()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose dfc_sa_unet_torch is timed (default: this one)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: scripts/bench_torch_int8.py times kernels on a GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.infer.engine import DFCEngine
    from dfc_sa_unet_torch.infer.quant import AUTO_INT8_LEVELS, AUTO_INT8_OPS, Int8DFCEngine
    from dfc_sa_unet_torch.ops import conv_s8 as ops

    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    b = args.batch
    print(f"card: {card}; torch {torch.__version__}; conv3x3_s8, bf16 out, B={b}; dfc_sa_unet_torch from "
          f"{os.path.abspath(args.root)}", flush=True)
    sums = [0.0] * 4
    with torch.inference_mode():
        for name, h, cin, cout in LEVELS:
            x8, w8, scale, bias = inputs(b, h, h, cin, cout, gen)
            check(ops, x8, w8, scale, bias)
            kern = timed(lambda: ops.conv3x3_s8(x8, w8, scale, bias), args.iters)
            plain = timed(lambda: ops.conv3x3_s8_plain(x8, w8, scale, bias), 2)
            bf16 = timed(yardstick(b, h, cin, cout, gen), args.iters)
            bound, by = bound_ms(b, h, cin, cout)
            nops = work(b, h, cin, cout)[1]
            for i, v in enumerate((kern, plain, bf16, bound)):
                sums[i] += v
            print(f"{name:10s} {h:3d}x{h:<3d} {cin:4d}->{cout:<4d} kernel {kern:8.3f} ms ({nops / kern / 1e9:7.1f} TOP/s)"
                  f"  plain {plain:8.3f} ms  bf16 yardstick {bf16:8.3f} ms  bound {bound:7.3f} ms ({by})  max abs err 0"
                  f"  ({card})", flush=True)
            del x8, w8, scale, bias
        print(f"the {len(LEVELS)} levels: kernel {sums[0]:.3f} ms  plain {sums[1]:.3f} ms  bf16 yardstick "
              f"{sums[2]:.3f} ms  bound {sums[3]:.3f} ms  ({card})", flush=True)

        weights = flagship_weights(args.seed, dev)
        xs = torch.from_numpy(np.random.default_rng(args.seed + 1).integers(0, 256, (b, IMG, IMG, 3), dtype=np.uint8))
        x = normalize(xs.to(dev), torch.bfloat16).permute(0, 3, 1, 2)
        fp = DFCEngine(CONFIG, weights, dtype=torch.bfloat16, device=dev, tail_kernel_levels="auto",
                       conv_kernel_levels="auto")
        sets = [("auto", "auto")] + [(n, [n]) for n in sorted(AUTO_INT8_OPS)] + [("AUTO_INT8_LEVELS",
                                                                                 sorted(AUTO_INT8_LEVELS))]
        print(f"int8 flagship forward, bf16, B={b}, {IMG}x{IMG}: level set: int8 ms (two runs) against the bf16 "
              f"engine's (before and after)  ({card})", flush=True)
        for label, levels in sets:
            q = Int8DFCEngine(CONFIG, weights, dtype=torch.bfloat16, device=dev, int8_levels=levels,
                              act_scales="timing", tail_kernel_levels="auto", conv_kernel_levels="auto")
            runs = [timed(lambda: fp(x), 3), timed(lambda: q(x), 3), timed(lambda: q(x), 3), timed(lambda: fp(x), 3)]
            ratio = (runs[0] + runs[3]) / (runs[1] + runs[2])
            print(f"{label:17s} int8 {runs[1]:8.2f} {runs[2]:8.2f} ms  engine {runs[0]:8.2f} {runs[3]:8.2f} ms  "
                  f"engine / int8 {ratio:.4f}  ({b / min(runs[1:3]) * 1e3:.1f} img/s on device; int8 levels "
                  f"{sorted(q.int8_levels)})  ({card})", flush=True)
            del q


if __name__ == "__main__":
    main()
