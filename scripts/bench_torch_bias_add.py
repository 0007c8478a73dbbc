#!/usr/bin/env python3
"""The bias pass of one served request on one GPU: the hand-written kernel against torch's add_.

    python3 scripts/bench_torch_bias_add.py [--model segformer|transunet|flagship] [--iters 20] [--seed 0]

Every ``Dense`` and biased ``Conv`` of the port adds its f32 bias to its bf16 product in place
(nn/layers.py::add_bias_ -> ops/bias_add.py::bias_add).  This script takes the biased outputs of
one request of a cell's model, shape by shape with the number of launches each shape has a
request (SegFormer-B5 at 16 1024x1024 tiles: 370; TransUNet R50-ViT-B/16 at 128 224x224 tiles:
74; the DFC-SA flagship module at 128 224x224 tiles: 64), and for each shape

  checks  - the kernel against ``y.clone().add_(bias)``: the same bits (``torch.equal``);
  kernel  - times ``ops.bias_add`` (csrc/bias_add.cu) in place, CUDA events over ``--iters``;
  torch   - times ``y.add_(bias)``, the plain version and what the layers ran before the kernel;
  bound   - the least time the card could take: each element read and written once in bf16, the
            bias once, over 3.35 TB/s.  Tensors below the 50 MB L2 stay there from one timed
            launch to the next, as a product just written by its GEMM may: those may read above
            their HBM bound.

The last line sums the shapes, each times its launches.  Needs a CUDA card.
"""

import argparse
import json
import math
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
CL = torch.channels_last


def segformer_shapes(batch=16, side=1024, dims=(64, 128, 320, 512), depths=(3, 6, 40, 3), ratios=(8, 4, 2, 1),
                     decoder=768):
    """[(label, y shape, layout, launches a request)] of SegFormer-B5's biased outputs: Dense outputs
    as tokens [B,N,C] (layout None), convs NCHW stored channels_last."""
    out = []
    for i, (c, depth, r) in enumerate(zip(dims, depths, ratios), start=1):
        s = side >> (i + 1)
        out += [(f"s{i}.patch_embed", (batch, c, s, s), CL, 1),
                (f"s{i}.q_proj_fc2", (batch, s * s, c), None, 3 * depth),
                (f"s{i}.kv", (batch, (s // r) ** 2, 2 * c), None, depth),
                (f"s{i}.fc1", (batch, s * s, 4 * c), None, depth),
                (f"s{i}.dwconv", (batch, 4 * c, s, s), CL, depth)]
        if r > 1:
            out.append((f"s{i}.sr", (batch, c, s // r, s // r), CL, depth))
        out.append((f"s{i}.linear_c", (batch, s * s, decoder), None, 1))
    out.append(("linear_pred", (batch, 1, side // 4, side // 4), CL, 1))
    return out


def transunet_shapes(batch=128, tokens=196, hidden=768, mlp=3072, layers=12, side=224):
    """The same for TransUNet R50-ViT-B/16: the patch embedding, 12 layers x (q, k, v, out, fc1,
    fc2), the C = 1 segmentation head."""
    grid = int(math.isqrt(tokens))
    return [("patch_embed", (batch, hidden, grid, grid), CL, 1),
            ("qkv_out_fc2", (batch, tokens, hidden), None, 5 * layers),
            ("fc1", (batch, tokens, mlp), None, layers),
            ("seg_head", (batch, 1, side, side), CL, 1)]


def flagship_shapes(batch=128, side=224, features=(64, 128, 256, 512), pool=8):
    """The same for the DFC-SA flagship module (the module path, which training and serving without
    the engine take; the engine adds its biases itself): eight convs at each of the four levels'
    resolutions, four at the bottleneck's, 31 on the attention's ``pool`` x ``pool`` maps at eight
    widths, and the C = 1 output conv, one NCHW-contiguous plane an image: 64."""
    pooled = {features[0] // 8: 4, features[1] // 8: 4, features[2] // 8: 4, features[0]: 6, features[1]: 4,
              features[2]: 2, features[3]: 2, 2 * features[3]: 1}
    out = [(f"level{i}", (batch, c, side >> i, side >> i), CL, 8) for i, c in enumerate(features)]
    out.append(("bottleneck", (batch, 2 * features[3], side >> 4, side >> 4), CL, 4))
    out += [(f"pooled_c{c}", (batch, c, pool, pool), CL, n) for c, n in pooled.items()]
    out.append(("out", (batch, 1, side, side), None, 1))
    return out


MODELS = {"segformer": segformer_shapes, "transunet": transunet_shapes, "flagship": flagship_shapes}


def inputs(shape, layout, generator, dtype=torch.bfloat16):
    """A product-like y and its f32 bias (along dim 1 of a 4-D y, else the last)."""
    dev = generator.device
    y = (torch.randn(shape, generator=generator, device=dev) * 3).to(dtype)
    if layout is not None:
        y = y.contiguous(memory_format=layout)
    c = shape[1] if len(shape) == 4 else shape[-1]
    bias = torch.randn(c, generator=generator, device=dev)
    return y, (bias.view(-1, 1, 1) if len(shape) == 4 else bias)


def measure(model, timed, iters, generator, dtype=torch.bfloat16, **sizes):
    """[{label, shape, launches, same_bits, max_abs_err, bytes, bound_ms, and with ``timed`` ms,
    torch_ms}] for ``model``'s shapes (``sizes``: its shape function's batch and side), y in
    ``dtype``, a launch each: checked against torch's add_, then timed with ``timed(fn, iters)`` (ms
    a call) where ``timed`` is given."""
    from dfc_sa_unet_torch.ops.bias_add import bias_add, kernel_layout

    rows = []
    for label, shape, layout, count in MODELS[model](**sizes):
        y, bias = inputs(shape, layout, generator, dtype)
        if kernel_layout(y, bias) is None:
            raise RuntimeError(f"{model} {label} {shape}: the kernel does not take this layout")
        want = y.clone(memory_format=torch.preserve_format).add_(bias)
        got = bias_add(y.clone(memory_format=torch.preserve_format), bias)
        same, err = torch.equal(got, want), (got.float() - want.float()).abs().max().item()
        del got, want
        nbytes = 2 * y.numel() * y.element_size() + 4 * bias.numel()
        row = {"label": label, "shape": list(shape), "launches": count, "same_bits": same, "max_abs_err": err,
               "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        if timed is not None:
            row.update(ms=timed(lambda: bias_add(y, bias), iters), torch_ms=timed(lambda: y.add_(bias), iters))
        rows.append(row)
        del y, bias
    return rows


def totals(rows):
    """Each time summed over a request's launches."""
    return {key: sum(r[key] * r["launches"] for r in rows) for key in ("ms", "torch_ms", "bound_ms")} | {
        "launches": sum(r["launches"] for r in rows)}


def cuda_timer(fn, iters):
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default=None, help="default: both")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    print(f"card: {card}; torch {torch.__version__}; bias pass, bf16 y, f32 bias", flush=True)
    bad = []
    with torch.inference_mode():
        for model in [args.model] if args.model else sorted(MODELS):
            rows = measure(model, cuda_timer, args.iters, gen)
            for r in rows:
                print(f"{model:9s} {r['label']:16s} {str(tuple(r['shape'])):24s} x{r['launches']:3d}  kernel "
                      f"{r['ms']:8.4f} ms  torch {r['torch_ms']:8.4f} ms  bound {r['bound_ms']:8.4f} ms "
                      f"({100 * r['bound_ms'] / r['ms']:5.1f}%)  same bits {r['same_bits']}", flush=True)
                if not r["same_bits"]:
                    bad.append(f"{model} {r['label']}")
            t = totals(rows)
            print(f"{model}: a request's {t['launches']} launches: kernel {t['ms']:.3f} ms  torch {t['torch_ms']:.3f} "
                  f"ms  bound {t['bound_ms']:.3f} ms ({card})", flush=True)
            print(json.dumps({"model": model, "card": card, "totals": t, "rows": rows}))
    if bad:
        sys.exit(f"the kernel and torch's add_ differ: {bad}")


if __name__ == "__main__":
    main()
