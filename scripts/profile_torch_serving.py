#!/usr/bin/env python3
"""Where the time of one bf16 serving forward goes, for the PyTorch port on one GPU.

    python3 scripts/profile_torch_serving.py [--model NAME] [--batch 128] [--size 224] [--seed 0]
                                             [--top 25] [--report FILE]

Builds one served model at full width with seeded weights: the flagship
``DFC-SA-Res-Block`` (224x224, features 64/128/256/512, pool 8; the
default), the vanilla ``UNet`` (64..1024), one of the eight ``UNet_*``
ablations (the flagship's widths and pool size; give
``UNet_FullResAttention`` ``--size 64``, the largest image its attention
takes), ``VisionTransformerSegmentation`` (ViT-B/16 at 224x224) or
``TransformerUNet`` (R50-ViT-B/16).  For each of its serving paths (the
flagship's module path with the attention kernel and its folded engine
path with the tail, conv3x3 and attention kernels; the one module path of
any other model) it times one B-image
bf16 forward with CUDA events and traces two forwards with torch.profiler:
device time by kernel, the device's busy share of the traced wall time,
and device time by the program's spans (``utils/profiling.py::span``: the
flagship engine's ``engine.*`` parts, TransUNet's ``transunet.*``; a model
without spans prints none): the kernels' time inside each span's
device-side range in the trace, the range's length (which counts the
device's idle inside it too) and, for a timed span, its CUDA events' time.
Prints a summary; ``--report`` also writes the profiler's full tables to
FILE, where the spans are the ``dfc.*`` rows.  Needs a CUDA card.
"""

import argparse
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dfc_sa_unet_torch.infer.engine import DFCEngine  # noqa: E402
from dfc_sa_unet_torch.models.factory import create_model  # noqa: E402
from dfc_sa_unet_torch.utils import profiling  # noqa: E402
from dfc_sa_unet_torch.utils.weights import init_random_  # noqa: E402

# the model sections of configs/config_dfc-sa-res-block.yaml, config_vit_seg.yaml and
# config_transunet.yaml (with the dataset's image size, which sizes TransUNet)
CONFIGS = {
    "DFC-SA-Res-Block": {"model": {"name": "DFC-SA-Res-Block", "features": [64, 128, 256, 512], "pool_size": 8,
                                   "use_pallas": True}},
    "VisionTransformerSegmentation": {"model": {"name": "VisionTransformerSegmentation", "img_dim": 224,
                                                "patch_dim": 16, "embed_dim": 768, "num_layers": 12,
                                                "num_heads": 12, "mlp_dim": 3072, "dropout": 0.1}},
    "TransformerUNet": {"model": {"name": "TransformerUNet", "in_channels": 3, "out_channels": 1},
                        "dataset": {"img_size": [224, 224]}},
    "UNet": {"model": {"name": "UNet", "bilinear": False}},
}
# configs/config_ablation*.yaml: the flagship's widths and pool size under each ablation's name
for _name in ("UNet_Baseline", "UNet_AttentionOnly", "UNet_AdditionFusion", "UNet_ConcatFusion",
              "UNet_FullResAttention", "UNet_EncoderOnlyDFC", "UNet_DecoderOnlyDFC", "UNet_BothStandardConv"):
    CONFIGS[_name] = {"model": {"name": _name, "features": [64, 128, 256, 512], "pool_size": 8, "use_pallas": True}}


def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0)


def _is_kernel(evt):
    """A device-side row (a kernel or copy); operator rows repeat their time, and so does the
    device's annotation of a span."""
    return evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(evt, "is_user_annotation", False)


def _union(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _by_span(events, records, forwards):
    """Per span name, in ms a forward: the union of the kernels inside its device-side ranges (the
    trace's annotations of its ``record_function``), the ranges' length, and its CUDA events' time
    (None for an untimed span); and its count a forward.  Copies are left out, as from the kernels'
    busy time."""
    ranges, kernels = {}, []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        lo, hi = float(e.time_range.start), float(e.time_range.end)
        if getattr(e, "is_user_annotation", False):
            if e.name.startswith(profiling.SPAN_PREFIX):
                ranges.setdefault(e.name[len(profiling.SPAN_PREFIX):], []).append((lo, hi))
        elif not e.name.startswith(("Memcpy", "Memset")):
            kernels.append((lo, hi))
    kernels = _union(kernels)
    timed = {}
    for r in records:
        if r.device_ms is not None:
            timed[r.name] = timed.get(r.name, 0.0) + r.device_ms
    rows = []
    for name, spans in ranges.items():
        inside = sum(max(0.0, min(k_hi, hi) - max(k_lo, lo)) for lo, hi in spans for k_lo, k_hi in kernels)
        length = sum(hi - lo for lo, hi in spans)
        events_ms = timed[name] / forwards if name in timed else None
        rows.append((name, inside / 1e3 / forwards, length / 1e3 / forwards, events_ms, len(spans) // forwards))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=sorted(CONFIGS), default="DFC-SA-Res-Block")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=224, help="image height and width")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--report", type=str, default=None, help="file for the full profiler tables")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    config = CONFIGS[args.model]
    weights = init_random_(create_model(config, device="cpu"), torch.Generator().manual_seed(args.seed)).state_dict()
    module = create_model(config, dtype=torch.bfloat16, device=dev).eval()
    module.load_state_dict(weights, strict=True)
    paths = [("module", module)]
    if args.model == "DFC-SA-Res-Block":
        paths.append(("engine", DFCEngine(config, weights, dtype=torch.bfloat16, device=dev,
                                          tail_kernel_levels="auto", conv_kernel_levels="auto")))
    x = torch.randn(args.batch, 3, args.size, args.size, generator=torch.Generator().manual_seed(args.seed))
    x = x.to(dev, torch.bfloat16, memory_format=torch.channels_last)

    tables = []
    print(f"card: {card}; torch {torch.__version__}; {args.model}, B={args.batch} bf16 {args.size}x{args.size}")
    with torch.inference_mode():
        for name, fwd in paths:
            fwd(x)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                fwd(x)
            end.record()
            torch.cuda.synchronize()
            fwd_ms = start.elapsed_time(end) / 3
            profiling.reset_spans()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(2):
                    fwd(x)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            averages = prof.key_averages()
            kernels = [e for e in averages if _is_kernel(e)]
            busy_us = sum(_device_us(e) for e in kernels)
            print(f"\n{name} path: forward {fwd_ms:.2f} ms (CUDA events, {card}); traced 2 forwards: "
                  f"device busy {busy_us / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
                  f"({100 * busy_us / wall_us:.1f}%)")
            rows = sorted(kernels, key=_device_us, reverse=True)
            for e in rows[: args.top]:
                us = _device_us(e)
                if us <= 0:
                    break
                print(f"  {us / 2e3:9.3f} ms/forward {100 * us / busy_us:5.1f}%  x{e.count // 2:<5d} {e.key[:160]}")
            span_rows = _by_span(prof.events(), profiling.spans(), 2)
            if span_rows:
                print(f"  by span (kernels inside its device-side ranges; {sum(r[1] for r in span_rows):.3f} "
                      f"ms/forward in all), range, CUDA events where timed:")
            for span, kernel_ms, range_ms, events_ms, n in span_rows:
                ev = "-" if events_ms is None else f"{events_ms:.3f}"
                print(f"  {kernel_ms:9.3f} ms/forward {100 * kernel_ms / fwd_ms:5.1f}%  range {range_ms:9.3f}"
                      f"  events {ev:>9s}  x{n:<5d} {profiling.SPAN_PREFIX}{span}")
            tables.append(f"== {args.model} {name} path ({card}, B={args.batch} bf16)\n"
                          + averages.table(sort_by="self_device_time_total", row_limit=100) + "\n")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w", encoding="utf-8") as f:
            f.writelines(tables)


if __name__ == "__main__":
    main()
