#!/usr/bin/env python3
"""The flagship's 9 pooled-attention launches (N = 64, bf16) of one checkout's package, for runs in turns.

    python3 scripts/bench_torch_attention_turns.py ROOT

Times the nine launches of the flagship's attention levels (C 64..1024, C' = C / 8) at B=128, where
the launch itself weighs, and at B=1024, where the kernel does: 100 launches a reading, the least of
5 readings, CUDA events.  ``ROOT`` is a checkout whose ``dfc_sa_unet_torch`` is imported and built
(e.g. a parent unpacked with ``git archive PARENT dfc_sa_unet_torch | tar -x -C DIR``); run parent,
change, change, parent in one call to compare two trees on one card.  Prints one JSON line, with
the card's name and power limit.
"""

import json
import os
import subprocess
import sys

import torch

CHANNELS = (64, 128, 256, 512, 1024, 512, 256, 128, 64)  # the flagship's nine levels


def timed(fn, iters):
    """Milliseconds a call of ``fn`` over ``iters`` calls after one warm-up, by CUDA events."""
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
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: bench_torch_attention_turns.py times the kernels on the card")
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    from dfc_sa_unet_torch.ops import _build, pooled_attention as attn

    assert attn.__file__.startswith(root + "/"), attn.__file__
    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"root": sys.argv[1], "card": card}
    with torch.inference_mode():
        for b in (128, 1024):
            ins = []
            for c in CHANNELS:
                q, k = (torch.randn(b, 8, 8, c // 8, generator=gen, device="cuda").bfloat16() for _ in range(2))
                ins.append((q, k, torch.randn(b, 8, 8, c, generator=gen, device="cuda").bfloat16()))

            def nine():
                for q, k, v in ins:
                    attn.pooled_attention(q, k, v)

            out[f"B{b}"] = min(timed(nine, 100) for _ in range(5))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
