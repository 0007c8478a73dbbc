#!/usr/bin/env python3
"""The Predictor's batch policy measured on the card: each batch size served as it is (native)
and under the policy the JAX Predictor measured on a TPU v5e (batches of 64-127 zero-padded to
128, batches above 128 in chunks of 128; dfc_sa_unet_tpu/infer/predictor.py:170-177).

    python3 scripts/bench_torch_predictor_batch.py [--sizes 32,48,...] [--runs 2] [--reps 3]
                                                   [--seed 0]

The flagship DFC-SA-Res-Block at full width (224x224, features 64/128/256/512, pool 8, seeded
weights) in bf16, on its folded engine (tail kernel on the 7 "auto" levels, conv3x3 kernel on the
other two) and on its module path.  For every batch size and path, in turns (native first in odd runs,
the policy first in even ones), it times ``predict_probs``' work on uint8 images (host clock around the call, which ends
on the copy of the probabilities to the host: median of ``--reps``) and the device forward of the
same normalised batch (CUDA events: median of ``--reps``); the whole sweep runs ``--runs`` times.
Prints one row per batch size and path with each run's times, the policy's gain and the spread
between runs, a verdict (the policy is kept only where it is faster, in ``predict_probs`` and in
the device forward, by more than that spread in every run), and last one JSON line of every
number.  Needs a CUDA card.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dfc_sa_unet_torch.data.normalize import normalize  # noqa: E402
from dfc_sa_unet_torch.infer.engine import DFCEngine  # noqa: E402
from dfc_sa_unet_torch.infer.predictor import Predictor  # noqa: E402
from dfc_sa_unet_torch.models.factory import create_model  # noqa: E402
from dfc_sa_unet_torch.utils.weights import init_random_  # noqa: E402

# configs/config_dfc-sa-res-block.yaml, model section
CONFIG = {"model": {"name": "DFC-SA-Res-Block", "in_channels": 3, "out_channels": 1,
                    "features": [64, 128, 256, 512], "pool_size": 8}}
SIZES = (32, 48, 63, 64, 96, 112, 127, 128, 144, 160, 192, 256)
IMG = 224


def v5e_policy(run, images):
    """``run`` over ``images`` as the JAX Predictor batches them: above 128 in chunks of 128 (each
    under the policy again), 64-127 zero-padded to 128, below 64 as they are."""
    n = images.shape[0]
    if n > 128:
        return np.concatenate([v5e_policy(run, images[lo:lo + 128]) for lo in range(0, n, 128)])
    if 64 <= n < 128:
        pad = np.zeros((128 - n, *images.shape[1:]), images.dtype)
        return v5e_policy(run, np.concatenate([images, pad]))[:n]
    return run(images)


def native(run, images):
    return run(images)


def time_predict(pred, policy, images, reps):
    """Median ms of ``predict_probs``' work under ``policy`` (host clock; it ends on a device-to-host
    copy), after one call that warms the shapes."""
    policy(pred._forward_u8, images)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = policy(pred._forward_u8, images)
        times.append((time.perf_counter() - t0) * 1e3)
    assert out.shape == images.shape[:3]
    return float(np.median(times))


@torch.inference_mode()
def time_forward(pred, policy, x, reps):
    """Median device ms (CUDA events) of the forward of the normalised NCHW batch ``x`` under
    ``policy`` (the padding and the chunks as in ``v5e_policy``)."""
    def run(xs):
        return pred.model(xs)

    def policed(xs):
        n = xs.shape[0]
        if policy is native:
            return run(xs)
        if n > 128:
            return [policed(xs[lo:lo + 128]) for lo in range(0, n, 128)]
        if 64 <= n < 128:
            return run(torch.cat([xs, xs.new_zeros((128 - n, *xs.shape[1:]))]).contiguous(
                memory_format=torch.channels_last))
        return run(xs)

    policed(x)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        policed(x)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=str, default=",".join(map(str, SIZES)))
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    sizes = [int(s) for s in args.sizes.split(",")]
    weights = init_random_(create_model(CONFIG, device="cpu"), torch.Generator().manual_seed(args.seed)).state_dict()
    module = create_model(CONFIG, dtype=torch.bfloat16, device=dev)
    module.load_state_dict(weights, strict=True)
    engine = DFCEngine(CONFIG, weights, dtype=torch.bfloat16, device=dev, tail_kernel_levels="auto",
                       conv_kernel_levels="auto")
    preds = {"engine": Predictor(engine, compute_dtype=torch.bfloat16, device=dev),
             "module": Predictor(module, compute_dtype=torch.bfloat16, device=dev)}
    images = np.random.default_rng(args.seed).integers(0, 256, (max(sizes), IMG, IMG, 3), dtype=np.uint8)
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    # results[path][size][mode] = {"predict_ms": [run 1, run 2, ...], "forward_ms": [...]}
    results = {p: {n: {m: {"predict_ms": [], "forward_ms": []} for m in ("native", "policy")} for n in sizes}
               for p in preds}
    t_all = time.perf_counter()
    for run in range(args.runs):
        for n in sizes:
            x = normalize(torch.from_numpy(images[:n]).to(dev), torch.bfloat16).permute(0, 3, 1, 2)
            for path, pred in preds.items():
                modes = (("native", native), ("policy", v5e_policy))
                for mode, policy in modes if run % 2 == 0 else modes[::-1]:  # alternate which goes first
                    r = results[path][n][mode]
                    with torch.inference_mode():
                        r["predict_ms"].append(time_predict(pred, policy, images[:n], args.reps))
                    r["forward_ms"].append(time_forward(pred, policy, x, args.reps))
            del x
            torch.cuda.empty_cache()
        print(f"run {run + 1} done in {time.perf_counter() - t_all:.1f} s", flush=True)
    verdicts = {}
    for path in preds:
        print(f"{path}, bf16, {IMG}x{IMG} ({card}): B | predict_probs ms native / policy, each run | device "
              f"forward ms native / policy, each run | the policy's gain, worst run: predict_probs (forward) | "
              f"spread between runs: predict_probs (forward) | verdict")
        for n in sizes:
            nat, pol = results[path][n]["native"], results[path][n]["policy"]
            # per metric: the policy's gain in the run where it gained least, against the largest
            # spread of either mode's runs; the verdict reads predict_probs (what a caller waits for)
            # and needs the device forward to agree; a size the policy does not change gets none
            gain, spread = {}, {}
            for metric in ("predict_ms", "forward_ms"):
                gain[metric] = min(a - b for a, b in zip(nat[metric], pol[metric]))
                spread[metric] = max(max(v) - min(v) for v in (nat[metric], pol[metric]))
            faster = all(gain[m] > spread[m] for m in gain)
            changed = n > 128 or 64 <= n < 128
            verdict = ("policy faster" if faster else "keep native") if changed else "the same batch"
            verdicts[f"{path}/{n}"] = verdict
            print(f"  {n:4d} | {'/'.join(f'{v:.2f}' for v in nat['predict_ms'])} / "
                  f"{'/'.join(f'{v:.2f}' for v in pol['predict_ms'])} | "
                  f"{'/'.join(f'{v:.3f}' for v in nat['forward_ms'])} / "
                  f"{'/'.join(f'{v:.3f}' for v in pol['forward_ms'])} | "
                  f"{gain['predict_ms']:+.2f} ({gain['forward_ms']:+.3f}) | "
                  f"{spread['predict_ms']:.2f} ({spread['forward_ms']:.3f}) | {verdict}", flush=True)
    print(json.dumps({"card": card, "runs": args.runs, "reps": args.reps, "results": results, "verdicts": verdicts}))


if __name__ == "__main__":
    main()
