#!/usr/bin/env python3
"""The fused DFC tail kernel beside the library and its bound, level by level, on one GPU.

    python3 scripts/bench_torch_dfc_tail.py [--root DIR] [--batch 128] [--iters 3] [--seed 0]

``ops/dfc_tail.py::dfc_tail`` is what the folded engine (``infer/engine.py``)
launches at the flagship's seven "auto" levels (``AUTO_TAIL_LEVELS``).  This
script times it in bf16 at each of those levels (224x224 input, features
64/128/256/512, B=128) beside ``library``: the same function as cuDNN
convolutions (the 3x3 conv and three 1x1 convs) and torch's elementwise ops
in channels_last bf16, and beside the least time the card could take: the
larger of the bytes of x, a, the weights and out over 3.35 TB/s and the
2 C (9 Cin + 5 C + Cin) operations per pixel over 989 TFLOP/s.  ``--root
DIR`` imports ``dfc_sa_unet_torch`` from another checkout (the parent commit,
unpacked in a git-ignored directory), so that two versions of the kernel are
timed by the same script on the same card.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = 989e12          # dense bf16 on the tensor cores
# (level, H, Cin, C): the flagship's tail levels at 224x224 (infer/engine.py AUTO_TAIL_LEVELS)
LEVELS = [("down2", 112, 64, 128), ("down3", 56, 128, 256), ("down4", 28, 256, 512), ("up_conv4", 28, 1024, 512),
          ("up_conv3", 56, 512, 256), ("up_conv2", 112, 256, 128), ("up_conv1", 224, 128, 64)]


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


def inputs(b, h, cin, c, gen, dtype=torch.bfloat16):
    """x, a, wc, bc, wg, bg, wf, bf, wr of one level, seeded, scaled so that every term is O(1)."""
    def randn(*shape, scale=1.0, dt=dtype):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(dt)

    return (randn(b, h, h, cin), randn(b, h, h, c), randn(3, 3, cin, c, scale=(9 * cin) ** -0.5),
            randn(c, dt=torch.float32), randn(2 * c, c, scale=(2 * c) ** -0.5), randn(c, dt=torch.float32),
            randn(3 * c, c, scale=(3 * c) ** -0.5), randn(c, dt=torch.float32),
            randn(cin, c, scale=0.1 * cin ** -0.5))


def library(args):
    """The tail as one would write it with the library: a function of no arguments, on
    channels_last NCHW views of the same tensors (its weights laid out once, here)."""
    x, a, wc, bc, wg, bg, wf, bf, wr = args
    c, cin, dtype = a.shape[-1], x.shape[-1], a.dtype
    xc, ac = x.permute(0, 3, 1, 2), a.permute(0, 3, 1, 2)
    kc = wc.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    kg = wg.t().reshape(c, 2 * c, 1, 1).contiguous()
    kf = wf.t().reshape(c, 3 * c, 1, 1).contiguous()
    kr = wr.t().reshape(c, cin, 1, 1).contiguous()
    bcd, bgd, bfd = bc.to(dtype), bg.to(dtype), bf.to(dtype)

    def run():
        local = F.relu(F.conv2d(xc, kc, bcd, padding=1))
        g = torch.sigmoid(F.conv2d(torch.cat([local, ac], 1), kg, bgd))
        fused = g * local + (1 - g) * ac
        o = F.relu(F.conv2d(torch.cat([fused, local, ac], 1), kf, bfd))
        return o + F.conv2d(xc, kr)

    return run


def work(b, h, cin, c):
    """(bytes, operations) of one bf16 launch: x, a and out once, the weights once, f32 biases."""
    npix = b * h * h
    nbytes = 2 * npix * (cin + 2 * c) + 2 * (9 * cin * c + 5 * c * c + cin * c) + 4 * 3 * c
    return nbytes, 2 * npix * c * (9 * cin + 5 * c + cin)


def bound_ms(b, h, cin, c):
    nbytes, ops = work(b, h, cin, c)
    terms = {"bytes": nbytes / HBM_BYTES_PER_S, "operations": ops / PEAK_OPS}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose dfc_sa_unet_torch is timed (default: this one)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: scripts/bench_torch_dfc_tail.py times kernels on a GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from dfc_sa_unet_torch.ops import dfc_tail as ops

    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    b = args.batch
    print(f"card: {card}; torch {torch.__version__}; DFC tail, bf16, B={b}; dfc_sa_unet_torch from "
          f"{os.path.abspath(args.root)}", flush=True)
    sums = [0.0, 0.0, 0.0]
    with torch.inference_mode():
        for name, h, cin, c in LEVELS:
            level = inputs(b, h, cin, c, gen)
            kern = timed(lambda: ops.dfc_tail(*level), args.iters)
            lib = timed(library(level), args.iters)
            bound, by = bound_ms(b, h, cin, c)
            ops_count = work(b, h, cin, c)[1]
            for i, v in enumerate((kern, lib, bound)):
                sums[i] += v
            print(f"{name:9s} {h:3d}x{h:<3d} {cin:4d}->{c:<4d} kernel {kern:8.3f} ms ({ops_count / kern / 1e9:6.1f} TF/s)  "
                  f"library {lib:8.3f} ms  bound {bound:7.3f} ms ({by})  ({card})", flush=True)
            del level
    print(f"the {len(LEVELS)} levels: kernel {sums[0]:.3f} ms  library {sums[1]:.3f} ms  bound {sums[2]:.3f} ms  "
          f"({card})", flush=True)


if __name__ == "__main__":
    main()
