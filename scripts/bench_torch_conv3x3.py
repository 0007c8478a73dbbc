#!/usr/bin/env python3
"""The 3x3 conv + bias + ReLU kernel beside the library and its bound, at the levels the engine sends it, on one GPU.

    python3 scripts/bench_torch_conv3x3.py [--root DIR] [--batch 128] [--iters 5] [--seed 0]

``ops/dfc_tail.py::conv3x3_bn_relu`` is what the folded engine (``infer/engine.py``,
``AUTO_CONV_LEVELS``) launches at the flagship's down1 (224x224, 3 -> 64) and bottleneck
(14x14, 512 -> 1024) levels.  This script holds the wrapper to its plain version at each level
(2e-2 of the largest |reference|, after a launch on NaN inputs), then times in bf16 at B=128:
the wrapper (with any pass it runs before its kernel: an older checkout zero-pads down1's Cin
to 8, a pass timed alone on the next line; the kernel of this one reads the 3 channels as they are),
``library``: cuDNN's conv with the bias and a ReLU on channels_last views of the same tensors,
and the least time the card could take: the larger of the bytes of x, w, b and out once over
3.35 TB/s and the 2 * 9 Cin * Cout operations a pixel over 989 TFLOP/s.  ``--root DIR`` imports
``dfc_sa_unet_torch`` from another checkout (the parent commit, unpacked in a git-ignored
directory), so that two versions of the kernel are timed by the same script on the same card.
Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = 989e12          # dense bf16 on the tensor cores
TOL = 2e-2
# (level, H, Cin, Cout): the engine's conv levels at 224x224 (infer/engine.py AUTO_CONV_LEVELS)
LEVELS = [("down1", 224, 3, 64), ("bottleneck", 14, 512, 1024)]


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


def inputs(b, h, cin, cout, gen, dtype=torch.bfloat16):
    """x [B,H,H,Cin], w [3,3,Cin,Cout] scaled so that the sums are O(1), b [Cout] f32; seeded."""
    def randn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, generator=gen, device=gen.device) * scale).to(dt)

    return randn(b, h, h, cin), randn(3, 3, cin, cout, scale=(9 * cin) ** -0.5), randn(cout, dt=torch.float32)


def library(x, w, b):
    """The same function as one would write it with the library, on channels_last NCHW views."""
    xc = x.permute(0, 3, 1, 2)
    kc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    bd = b.to(x.dtype)
    return lambda: F.relu(F.conv2d(xc, kc, bd, padding=1))


def work(b, h, cin, cout, itemsize=2):
    """(bytes, operations) of one launch: x, w and out once in the activation type, b in f32."""
    npix = b * h * h
    return itemsize * (npix * (cin + cout) + 9 * cin * cout) + 4 * cout, 2 * npix * cout * 9 * cin


def bound_ms(b, h, cin, cout):
    nbytes, ops = work(b, h, cin, cout)
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / PEAK_OPS}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def check(ops, x, w, b):
    """max |kernel - plain| over max(1, max|plain|), after a launch on NaN inputs; raises above TOL."""
    ops.conv3x3_bn_relu(torch.full_like(x, float("nan")), w, b)
    got = ops.conv3x3_bn_relu(x, w, b)
    want = ops.conv3x3_bn_relu_plain(x, w, b)
    err = (got.float() - want.float()).abs().max().item()
    rel = err / max(1.0, want.float().abs().max().item())
    if not rel <= TOL or got.shape != want.shape:
        raise RuntimeError(f"conv3x3_bn_relu: kernel and plain version disagree: max abs err {err:.3e} "
                           f"({rel:.2e} of max|plain|, limit {TOL})")
    return err, rel


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose dfc_sa_unet_torch is timed (default: this one)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: scripts/bench_torch_conv3x3.py times kernels on a GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from dfc_sa_unet_torch.ops import dfc_tail as ops

    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    b = args.batch
    print(f"card: {card}; torch {torch.__version__}; conv3x3_bn_relu, bf16, B={b}; dfc_sa_unet_torch from "
          f"{os.path.abspath(args.root)}", flush=True)
    sums = [0.0, 0.0, 0.0]
    with torch.inference_mode():
        for name, h, cin, cout in LEVELS:
            x, w, bias = inputs(b, h, cin, cout, gen)
            err, rel = check(ops, x, w, bias)
            kern = timed(lambda: ops.conv3x3_bn_relu(x, w, bias), args.iters)
            lib = timed(library(x, w, bias), args.iters)
            bound, by = bound_ms(b, h, cin, cout)
            nbytes, nops = work(b, h, cin, cout)
            for i, v in enumerate((kern, lib, bound)):
                sums[i] += v
            print(f"{name:10s} {h:3d}x{h:<3d} {cin:4d}->{cout:<4d} kernel {kern:8.3f} ms ({nops / kern / 1e9:6.1f} TF/s, "
                  f"{nbytes / kern / 1e6:7.1f} GB/s)  library {lib:8.3f} ms  bound {bound:7.3f} ms ({by})  "
                  f"max abs err {err:.3e} ({rel:.1e} of max|plain|)  ({card})", flush=True)
            if cin % 8:
                pad = timed(lambda: F.pad(x, (0, -cin % 8)), args.iters)
                pads = not hasattr(ops, "conv_tiling") or ops.conv_tiling(cin, cout).cin != cin
                print(f"{'':10s} a zero-pad of x to Cin {cin - cin % 8 + 8} alone: {pad:8.3f} ms "
                      f"({'run' if pads else 'not run'} by this wrapper)  ({card})", flush=True)
            del x, w, bias
    print(f"the {len(LEVELS)} levels: kernel {sums[0]:.3f} ms  library {sums[1]:.3f} ms  bound {sums[2]:.3f} ms  "
          f"({card})", flush=True)


if __name__ == "__main__":
    main()
