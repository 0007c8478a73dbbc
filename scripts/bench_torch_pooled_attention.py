#!/usr/bin/env python3
"""The pooled-attention kernels beside SDPA and their bound, on one GPU.

    python3 scripts/bench_torch_pooled_attention.py [--batch 128] [--iters 20] [--seed 0]

``ops/pooled_attention.py::pooled_attention`` launches one of three
hand-written kernels (``entry_point``): in bf16 the tensor-core kernel at
every N; in f32 the 16-row SIMT kernel that keeps its energies in shared
memory (it takes N <= 1024) up to ``SHORT_TOKENS`` and the two-pass SIMT
kernel above.  This script times, at the shapes of both models that run the
kernel (the flagship's nine launches at N = 64, the full-resolution model's
nine at 64x64, and the bottleneck of pool 4), the bf16 kernel, and in f32
both SIMT kernels wherever both run (by moving the wrapper's threshold for
the length of a call), each beside ``F.scaled_dot_product_attention``
(scale 1.0) and the least time the card could take: the largest of the
bytes of q, k, v and out over 3.35 TB/s, the operations over the peak for
the type (989 TFLOP/s bf16 on the tensor cores, 67 f32 outside them) and the
B*N*N exponentials over 132 SMs x 16 a clock x the maximum SM clock.  Needs
a CUDA card.
"""

import argparse
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dfc_sa_unet_torch.ops import pooled_attention as ops  # noqa: E402

# (label, N, C): the flagship's nine levels at pool 8, the bottleneck at pool 4, and the
# full-resolution model's nine levels at 64x64 (N = H*H)
FLAGSHIP = [64, 128, 256, 512, 1024, 512, 256, 128, 64]
FULLRES = [(64, 64), (32, 128), (16, 256), (8, 512), (4, 1024), (8, 512), (16, 256), (32, 128), (64, 64)]
SHAPES = ([(f"flagship-{i}", 64, c) for i, c in enumerate(FLAGSHIP)] + [("pool4-bottleneck", 16, 1024)]
          + [(f"fullres-{i}", h * h, c) for i, (h, c) in enumerate(FULLRES)])
SHORT_KERNEL_MAX = 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SMS, EXP_PER_CLOCK = 132, 16


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
    """ms of one launch with the wrapper's f32 threshold moved to ``threshold``."""
    keep = ops.SHORT_TOKENS
    ops.SHORT_TOKENS = threshold
    try:
        return timed(lambda: ops.pooled_attention(q, k, v), iters)
    finally:
        ops.SHORT_TOKENS = keep


def bound_ms(b, n, c, dtype, sm_mhz):
    """(ms, what bounds it) of one launch: bytes, operations or exponentials."""
    item = torch.tensor([], dtype=dtype).element_size()
    terms = {"bytes": item * b * n * 2 * (c // 8 + c) / HBM_BYTES_PER_S,
             "operations": 2 * b * n * n * (c // 8 + c) / PEAK_OPS[dtype],
             "exponentials": b * n * n / (SMS * EXP_PER_CLOCK * sm_mhz * 1e6)}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


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
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout.split()
    if not clock:
        raise RuntimeError("nvidia-smi gave no maximum SM clock: the exponential bound needs it")
    sm_mhz = float(clock[0])
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    b = args.batch
    print(f"card: {card}; maximum SM clock {sm_mhz:.0f} MHz; torch {torch.__version__}; pooled attention, B={b}; "
          f"bf16: {ops.entry_point(torch.bfloat16, 64)}; f32: the 16-row kernel up to N = {ops.SHORT_TOKENS}")
    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            sums = {}
            for label, n, c in SHAPES:
                q, k, v = (torch.randn(b, n, 1, ch, generator=gen, device="cuda").to(dtype) for ch in (c // 8, c // 8, c))
                qs, ks, vs = (t.reshape(b, 1, n, -1) for t in (q, k, v))
                sdpa = timed(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), args.iters)
                bound, by = bound_ms(b, n, c, dtype, sm_mhz)
                if dtype == torch.bfloat16:
                    kern = timed(lambda: ops.pooled_attention(q, k, v), args.iters)
                    times = f"tensor-core {kern:8.4f} ms"
                else:
                    short = with_threshold(SHORT_KERNEL_MAX, q, k, v, args.iters) if n <= SHORT_KERNEL_MAX else None
                    kern = with_threshold(0, q, k, v, args.iters)
                    times = f"16-row {'     n/a' if short is None else f'{short:8.4f}'} ms  two-pass {kern:8.4f} ms"
                    kern = short if short is not None and n <= ops.SHORT_TOKENS else kern  # what the wrapper launches
                model = label.split("-")[0]
                acc = sums.setdefault(model, [0.0, 0.0, 0.0])
                acc[0] += kern
                acc[1] += sdpa
                acc[2] += bound
                print(f"{dn:8s} {label:18s} N={n:5d} C={c:5d}  {times}  SDPA {sdpa:8.4f} ms  "
                      f"bound {bound:7.4f} ms ({by})  ({card})", flush=True)
            for model in ("flagship", "fullres"):
                k_ms, s_ms, b_ms = sums[model]
                print(f"{dn:8s} {model}'s 9 launches: kernel {k_ms:.4f} ms  SDPA {s_ms:.4f} ms  bound {b_ms:.4f} ms  "
                      f"({card})", flush=True)


if __name__ == "__main__":
    main()
