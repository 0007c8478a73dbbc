#!/usr/bin/env python3
"""Training BatchNorm-statistics probe on one GPU: does a conv3x3 whose epilogue
also writes the per-channel sums beat a conv followed by separate reductions?

    python3 scripts/bench_torch_bn_stats.py [--root DIR] [--batch 128] [--iters 10] [--levels down1,down2]

Counterpart of scripts/bench_bn_stats.py for the PyTorch port, forward only,
bf16, at the four encoder levels of the flagship:

  kernel  - ops/conv_bn_stats.py::conv3x3_bias_stats, the hand-written CUDA
            kernel (y written once, per-tile f32 sums beside it), with the
            wrapper's own passes (the weight's packing, the sum of the rows)
  plain   - its plain PyTorch version (f32 conv, the kernel's arithmetic)
  library - cuDNN's conv in bf16 plus mean and mean-of-squares reductions
            over its output (``torch.var_mean``-style second pass)
  bound   - the least time the card could take: the larger of
            bytes / 3.35 TB/s (x and y once, the weights) and
            operations / 989 TFLOP/s (bf16 tensor cores, dense)

Each level is first checked against the plain version (2e-2 of max(1,
max|plain|), as the JAX probe's own check) after a launch on NaN inputs, then
timed with CUDA events, beside two parts of its time: the same conv without
the statistics (``conv3x3_bn_relu``) and the wrapper's sum of the partial
rows alone; a last line sums the levels.  ``--root DIR`` imports
``dfc_sa_unet_torch`` from another checkout (the parent commit, unpacked in a
git-ignored directory), so that two versions of the kernel are timed by the
same script on the same card.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

LEVELS = [("down1", 224, 3, 64), ("down2", 112, 64, 128), ("down3", 56, 128, 256), ("down4", 28, 256, 512)]
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_BF16_OPS = 989e12


def inputs(batch, h, cin, cout, generator, dtype=torch.bfloat16):
    """x, w, b as the JAX probe draws them (bench_bn_stats.py:133-135)."""
    dev = generator.device
    x = torch.randn(batch, h, h, cin, generator=generator, device=dev).to(dtype)
    w = (torch.randn(3, 3, cin, cout, generator=generator, device=dev) * 0.05).to(dtype)
    b = torch.rand(cout, generator=generator, device=dev) * 0.2 - 0.1
    return x, w, b


def library(x, w_oihw, b):
    """One cuDNN conv in x's dtype and the two reductions over its output."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, b.to(x.dtype), padding=1)
    yf = y.float()
    return y, yf.mean(dim=(0, 2, 3)), (yf * yf).mean(dim=(0, 2, 3))


def work(batch, h, cin, cout, itemsize=2):
    """(bytes, operations) of one level: x and y once, the weight and the bias; 2 * 9 Cin a value."""
    npix = batch * h * h
    return itemsize * npix * (cin + cout) + itemsize * 9 * cin * cout + 4 * cout, 2 * npix * cout * 9 * cin


def bound_ms(batch, h, cin, cout, itemsize=2):
    nbytes, ops = work(batch, h, cin, cout, itemsize)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / PEAK_BF16_OPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose dfc_sa_unet_torch is timed (default: this one)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--levels", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    from dfc_sa_unet_torch.ops import conv_bn_stats as ops, launches, reset_launches
    from dfc_sa_unet_torch.ops.conv_bn_stats import conv3x3_bias_stats, conv3x3_bias_stats_plain
    from dfc_sa_unet_torch.ops.dfc_tail import conv3x3_bn_relu

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    wanted = set(args.levels.split(",")) if args.levels else None
    print(f"card: {card}; torch {torch.__version__}; conv3x3 + bias + BatchNorm sums, bf16, B={args.batch}; "
          f"dfc_sa_unet_torch from {os.path.abspath(args.root)}", flush=True)
    sums = [0.0, 0.0, 0.0, 0.0]
    reset_launches()
    with torch.inference_mode():
        for name, h, cin, cout in LEVELS:
            if wanted and name not in wanted:
                continue
            x, w, b = inputs(args.batch, h, cin, cout, gen)
            conv3x3_bias_stats(torch.full_like(x, float("nan")), w, b)  # stale shared memory would show as NaN
            got, want = conv3x3_bias_stats(x, w, b), conv3x3_bias_stats_plain(x, w, b)
            errs = [(g.float() - r.float()).abs().max().item() / max(1.0, r.float().abs().max().item())
                    for g, r in zip(got, want)]
            if not all(e <= 2e-2 for e in errs):
                sys.exit(f"{name}: kernel and plain version disagree: relative errors {errs}")
            del got, want
            w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            t_kernel = timed(lambda: conv3x3_bias_stats(x, w, b), args.iters)
            t_plain = timed(lambda: conv3x3_bias_stats_plain(x, w, b), max(2, args.iters // 3))
            t_lib = timed(lambda: library(x, w_oihw, b), args.iters)
            bound, by = bound_ms(args.batch, h, cin, cout)
            for i, v in enumerate((t_kernel, t_plain, t_lib, bound)):
                sums[i] += v
            print(f"{name:6s} {h:3d} {cin:4d}->{cout:4d}  kernel {t_kernel:8.3f} ms  plain {t_plain:8.3f} ms  "
                  f"library {t_lib:8.3f} ms  bound {bound:7.3f} ms ({by})  kernel/library {t_kernel / t_lib:5.2f}x  "
                  f"max rel err y {errs[0]:.1e} mean {errs[1]:.1e} mean2 {errs[2]:.1e}  ({card})", flush=True)
            # where the kernel's time goes: the same conv without the statistics, and the wrapper's sum of
            # the partial rows alone (a checkout that has row_means)
            parts = f"conv3x3_bn_relu on the same inputs {timed(lambda: conv3x3_bn_relu(x, w, b), args.iters):.3f} ms"
            if hasattr(ops, "row_means"):
                npix = args.batch * h * h
                partial = ops.partial_buffer(npix, cin, cout, x.dtype, x.device)
                parts += (f", the sum of the {ops.partial_rows(npix, cin, cout, x.dtype)} partial rows "
                          f"{timed(lambda: ops.row_means(partial, npix), args.iters):.3f} ms")
            print(f"{'':6s} {parts}  ({card})", flush=True)
            del x, w, b, w_oihw
    print(f"the levels: kernel {sums[0]:.3f} ms  plain {sums[1]:.3f} ms  library {sums[2]:.3f} ms  "
          f"bound {sums[3]:.3f} ms  ({card})", flush=True)
    print(f"launches: {launches()['conv3x3_bias_stats']}")


if __name__ == "__main__":
    main()
