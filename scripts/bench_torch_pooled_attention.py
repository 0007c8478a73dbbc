#!/usr/bin/env python3
"""The two pooled-attention kernels beside each other and beside SDPA, on one GPU.

    python3 scripts/bench_torch_pooled_attention.py [--batch 128] [--iters 20] [--seed 0]

``ops/pooled_attention.py::pooled_attention`` picks one of two hand-written
kernels by the token count N: the 16-row kernel that keeps its energies in
shared memory (it takes N <= 1024) and the two-pass kernel that streams the
keys twice (any N <= 4096).  This script times both at every shape where both
run, by moving the wrapper's threshold for the length of a call, together with
``F.scaled_dot_product_attention`` (scale 1.0) and the byte/operation bound:
at the flagship's nine launches (N = 64), at pool sizes 4, 16 and 32 and at
the full-resolution model's levels at 64x64.  bf16 and f32.  It says what the
threshold ``SHORT_TOKENS`` should be.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dfc_sa_unet_torch.ops import pooled_attention as ops  # noqa: E402

# (N, C): the flagship's levels at pool 8, its bottleneck at pool 4, pools 16 and 32 at down3's
# and down2's widths, and the full-resolution model's levels at 64x64
SHAPES = [(16, 1024), (64, 64), (64, 128), (64, 256), (64, 512), (64, 1024), (256, 256), (1024, 128), (4096, 64)]
SHORT_KERNEL_MAX = 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


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


def with_threshold(threshold, q, k, v, iters):
    """ms of one launch with the wrapper's threshold moved to ``threshold``."""
    keep = ops.SHORT_TOKENS
    ops.SHORT_TOKENS = threshold
    try:
        return timed(lambda: ops.pooled_attention(q, k, v), iters)
    finally:
        ops.SHORT_TOKENS = keep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: scripts/bench_torch_pooled_attention.py times kernels on a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    b = args.batch
    print(f"card: {card}; torch {torch.__version__}; pooled attention, B={b}; the wrapper launches the 16-row kernel "
          f"up to N = {ops.SHORT_TOKENS}")
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            for n, c in SHAPES:
                q, k, v = (torch.randn(b, n, 1, ch, generator=gen, device="cuda").to(dtype) for ch in (c // 8, c // 8, c))
                short = with_threshold(SHORT_KERNEL_MAX, q, k, v, args.iters) if n <= SHORT_KERNEL_MAX else None
                long = with_threshold(0, q, k, v, args.iters)
                qs, ks, vs = (t.reshape(b, 1, n, -1) for t in (q, k, v))
                sdpa = timed(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), args.iters)
                nbytes = q.element_size() * (2 * q.numel() + 2 * v.numel())
                bound = max(nbytes / HBM_BYTES_PER_S, 2 * b * n * n * (c // 8 + c) / PEAK_OPS[dtype]) * 1e3
                short_txt = "     n/a" if short is None else f"{short:8.4f}"
                print(f"{str(dtype).split('.')[-1]:8s} N={n:5d} C={c:5d}  16-row {short_txt} ms  two-pass {long:8.4f} ms  "
                      f"SDPA {sdpa:8.4f} ms  bound {bound:7.4f} ms  ({card})", flush=True)


if __name__ == "__main__":
    main()
