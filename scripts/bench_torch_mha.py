#!/usr/bin/env python3
"""The multi-head attention kernels beside SDPA and their bound, on one GPU.

    python3 scripts/bench_torch_mha.py [--root DIR] [--iters 20] [--seed 0]

``ops/mha.py::fused_mha`` (packed q, k, v, ViT-seg) and ``fused_mha_sep``
(separate, TransUNet) launch the kernel that ``entry_point`` names: in bf16
the one-pass wgmma kernel up to 256 tokens and the two-pass kernel above.
This script times, in bf16 at ViT-B/16's shape (B=128, N=196, E=768, 12
heads: one launch of the twelve in a forward of either model) and at a few
other token counts, each wrapper beside ``F.scaled_dot_product_attention``
on the same q, k, v and the least time the card could take: the largest of
the bytes of q, k, v and out over 3.35 TB/s, the 4 B h N^2 hd operations
over 989 TFLOP/s and the B h N^2 exponentials over 132 SMs x 16 a clock x
the maximum SM clock.  ``--root DIR`` imports ``dfc_sa_unet_torch`` from
another checkout (the parent commit, unpacked in a git-ignored directory),
so that two versions of the kernels are timed by the same script on the same
card.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys

import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = 989e12          # dense bf16 on the tensor cores
SMS, EXP_PER_CLOCK = 132, 16
LAYERS = 12  # launches of either model's forward at ViT-B/16
# (B, N, E, heads): ViT-B/16 at 224x224 (both models), then N at and around the one-pass
# kernel's limit, and the largest N the wrapper takes
SHAPES = [(128, 196, 768, 12), (128, 197, 768, 12), (64, 256, 768, 12), (64, 257, 768, 12), (8, 1024, 768, 12)]


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


def bound_ms(b, n, e, heads, sm_mhz):
    """(ms, what bounds it) of one bf16 launch: bytes, operations or exponentials."""
    terms = {"bytes": 2 * 4 * b * n * e / HBM_BYTES_PER_S,
             "operations": 4 * b * heads * n * n * (e // heads) / PEAK_OPS,
             "exponentials": b * heads * n * n / (SMS * EXP_PER_CLOCK * sm_mhz * 1e6)}
    by = max(terms, key=terms.get)
    return terms[by] * 1e3, by


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="checkout whose dfc_sa_unet_torch is timed (default: this one)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: scripts/bench_torch_mha.py times kernels on a GPU")
    sys.path.insert(0, os.path.abspath(args.root))
    from dfc_sa_unet_torch.ops import mha

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout.split()
    if not clock:
        raise RuntimeError("nvidia-smi gave no maximum SM clock: the exponential bound needs it")
    sm_mhz = float(clock[0])
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    entry = getattr(mha, "entry_point", lambda dtype, n: "mha_bf16")
    print(f"card: {card}; maximum SM clock {sm_mhz:.0f} MHz; torch {torch.__version__}; multi-head attention, "
          f"bf16; dfc_sa_unet_torch from {os.path.abspath(args.root)}", flush=True)
    with torch.inference_mode():
        for b, n, e, heads in SHAPES:
            qkv = torch.randn(b, n, 3 * e, generator=gen, device="cuda").to(torch.bfloat16)
            q, k, v = (t.contiguous() for t in qkv.chunk(3, dim=-1))
            q4, k4, v4 = (t.reshape(b, n, heads, e // heads).transpose(1, 2) for t in (q, k, v))
            packed = timed(lambda: mha.fused_mha(qkv, heads), args.iters)
            sep = timed(lambda: mha.fused_mha_sep(q, k, v, heads), args.iters)
            sdpa = timed(lambda: F.scaled_dot_product_attention(q4, k4, v4), args.iters)
            bound, by = bound_ms(b, n, e, heads, sm_mhz)
            print(f"B={b:4d} N={n:5d} E={e} heads={heads} {entry(torch.bfloat16, n):15s} fused_mha {packed:8.4f} ms  "
                  f"fused_mha_sep {sep:8.4f} ms  SDPA {sdpa:8.4f} ms  bound {bound:7.4f} ms ({by})  ({card})",
                  flush=True)
            if (b, n, e, heads) == (128, 196, 768, 12):
                print(f"    a forward's {LAYERS} launches: ViT-seg (fused_mha) {LAYERS * packed:.4f} ms, TransUNet "
                      f"(fused_mha_sep) {LAYERS * sep:.4f} ms, SDPA {LAYERS * sdpa:.4f} ms, bound "
                      f"{LAYERS * bound:.4f} ms  ({card})", flush=True)


if __name__ == "__main__":
    main()
