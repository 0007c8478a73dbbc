#!/usr/bin/env python3
"""The LayerNorms of one served request on one GPU: the hand-written kernel against torch's three passes.

    python3 scripts/bench_torch_layer_norm.py [--model segformer|transunet|vit_seg] [--rounds 8] [--iters 10]
                                              [--seed 0]

Every ``LayerNorm`` of the port (nn/layers.py) normalises its bf16 tokens in f32 and returns bf16
(ops/layer_norm.py::layer_norm).  This script takes the normalised tensors of one request of a
cell's model, shape by shape with the number of launches each has a request (SegFormer-B5 at 16
1024x1024 tiles: 161; TransUNet R50-ViT-B/16 at 128 224x224 tiles: 25; ViT-B/16 seg at 128: 24),
and for each shape

  checks  - the kernel, its output first filled with NaN, against the plain version
            (``layer_norm_plain``: x cast to f32, torch's layer_norm, the cast back) and both
            against an f64 LayerNorm of the same input (``check``, the gates below);
  kernel  - times ``ops.layer_norm`` (csrc/layer_norm.cu): ``--iters`` calls captured in a CUDA
            graph and replayed between CUDA events (``graph_timer``: the device's time, as in a
            served forward, where the host runs ahead),
  plain   - and the plain version, the two in turns, ``--rounds`` times: the median of each;
  bound   - the least time the card could take: x read and y written once in bf16 (gamma and
            beta once) over 3.35 TB/s.  Tensors below the 50 MB L2 stay there from one timed
            call to the next, as a residual sum just written may: those may read above their
            HBM bound.

Rows by stage, then the request's sum, each shape times its launches.  Needs a CUDA card; exits
non-zero where a gate fails.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
MAX_ULPS = 1  # bf16: every element within one ulp of the plain version (``ulps``) ...
MAX_DIFFERING = 0.01  # ... and at most this share of them differing from it
F32_TOL = 1e-5  # f32: |kernel - plain| <= F32_TOL * max(1, max|plain|), chip_smoke.py's TOL


def segformer_shapes(batch=16, side=1024, dims=(64, 128, 320, 512), depths=(3, 6, 40, 3), ratios=(8, 4, 2, 1)):
    """[(label, x shape, eps, launches a request)] of SegFormer-B5's LayerNorms, tokens [B, N, C]: a
    stage's patch embedding's norm (torch's default eps), its blocks' two norms and the stage's norm
    (1e-6), the reduction norms of the blocks whose keys are cut (default eps)."""
    out = []
    for i, (c, depth, r) in enumerate(zip(dims, depths, ratios), start=1):
        n = (side >> (i + 1)) ** 2
        out += [(f"s{i}.patch_embed", (batch, n, c), 1e-5, 1), (f"s{i}.tokens", (batch, n, c), 1e-6, 2 * depth + 1)]
        if r > 1:
            out.append((f"s{i}.reduction", (batch, n // (r * r), c), 1e-5, depth))
    return out


def transunet_shapes(batch=128, tokens=196, hidden=768, layers=12):
    """The same for TransUNet R50-ViT-B/16: 12 layers x 2 and the encoder's norm, eps 1e-6."""
    return [("encoder", (batch, tokens, hidden), 1e-6, 2 * layers + 1)]


def vit_seg_shapes(batch=128, tokens=196, hidden=768, layers=12):
    """The same for ViT-B/16 seg: 12 post-norm layers x 2, eps 1e-5."""
    return [("encoder", (batch, tokens, hidden), 1e-5, 2 * layers)]


MODELS = {"segformer": segformer_shapes, "transunet": transunet_shapes, "vit_seg": vit_seg_shapes}


def inputs(shape, generator, dtype=torch.bfloat16):
    """Token-like x (each row its own mean and spread), a weight near 1 and a bias near 0 (f32)."""
    dev = generator.device
    rows = shape[:-1] + (1,)
    x = (torch.randn(shape, generator=generator, device=dev) * (0.5 + torch.rand(rows, generator=generator, device=dev) * 3)
         + torch.randn(rows, generator=generator, device=dev) * 2).to(dtype)
    c = shape[-1]
    return x, 1 + 0.2 * torch.randn(c, generator=generator, device=dev), 0.2 * torch.randn(c, generator=generator, device=dev)


def ulps(got, want):
    """The largest |got - want| in units of bf16's spacing at each element of ``want``, the spacing
    taken at no less than 2^-8 of max|want|.  Below that an output is the near cancellation of its
    terms (gamma times the normalised x, beta), whose f32 roundings, about 2^-24 of the terms, may
    exceed bf16's spacing at the output itself: two sound f32 computations may then lie many of
    those spacings apart, or on either side of zero."""
    w = want.float()
    floor = max(w.abs().max().item() * 2.0 ** -8, 2.0 ** -126)
    spacing = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=floor))) - 7)
    return ((got.float() - w).abs() / spacing).max().item()


def check(x, weight, bias, eps):
    """The kernel on (x, weight, bias, eps), its output block first filled with NaN, against the plain
    version and both against an f64 LayerNorm of the same x: {ulps (the largest distance from the
    plain version, ``ulps``), differing (the share of elements that differ), max_abs_err (the
    largest |y - plain|), err and plain_err (the largest |y - f64|), ulp (bf16's spacing at the
    largest |f64| output), poisoned (whether the kernel's output took the NaN block), ok}.  bf16
    passes with ulps <= MAX_ULPS, differing <= MAX_DIFFERING and err <= plain_err + ulp; f32 with
    |kernel - plain| <= F32_TOL * max(1, max|plain|)."""
    from dfc_sa_unet_torch.ops.layer_norm import layer_norm, layer_norm_plain

    nan = torch.full_like(x, float("nan"))
    ptr = nan.data_ptr()
    del nan
    got = layer_norm(x, weight, bias, eps)
    poisoned = got.data_ptr() == ptr
    want = layer_norm_plain(x, weight, bias, eps)
    ref = torch.nn.functional.layer_norm(x.double(), (x.shape[-1],), weight.double(), bias.double(), eps)
    distance = ulps(got, want)
    differing = (got != want).float().mean().item()
    err = (got.double() - ref).abs().max().item()
    plain_err = (want.double() - ref).abs().max().item()
    top = ref.abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0
    finite = bool(torch.isfinite(got).all())
    if x.dtype == torch.bfloat16:
        ok = finite and distance <= MAX_ULPS and differing <= MAX_DIFFERING and err <= plain_err + ulp
    else:
        ok = finite and (got - want).abs().max().item() <= F32_TOL * max(1.0, want.abs().max().item())
    return {"ulps": distance, "differing": differing, "max_abs_err": (got.float() - want.float()).abs().max().item(),
            "err": err, "plain_err": plain_err, "ulp": ulp, "poisoned": poisoned, "ok": ok}


def measure(model, timed, rounds, iters, generator, dtype=torch.bfloat16, **sizes):
    """[{label, shape, eps, launches, the fields of ``check``, bytes, bound_ms, and with ``timed``
    ms and plain_ms}] for ``model``'s shapes (``sizes``: its shape function's batch and sizes), x in
    ``dtype``: checked, then timed in turns with ``timed(fn, iters)`` (ms a call), the median of
    ``rounds``, where ``timed`` is given."""
    from dfc_sa_unet_torch.ops.layer_norm import layer_norm, layer_norm_plain

    rows = []
    for label, shape, eps, count in MODELS[model](**sizes):
        x, w, b = inputs(shape, generator, dtype)
        nbytes = 2 * x.numel() * x.element_size() + 8 * shape[-1]
        row = {"label": label, "shape": list(shape), "eps": eps, "launches": count, **check(x, w, b, eps),
               "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        if timed is not None:
            ms, plain = [], []
            for _ in range(rounds):
                ms.append(timed(lambda: layer_norm(x, w, b, eps), iters))
                plain.append(timed(lambda: layer_norm_plain(x, w, b, eps), iters))
            row.update(ms=statistics.median(ms), plain_ms=statistics.median(plain))
        rows.append(row)
        del x, w, b
    return rows


def totals(rows, prefix=""):
    """Each time summed over a request's launches, of the timed rows whose label starts with ``prefix``."""
    rows = [r for r in rows if r["label"].startswith(prefix)]
    return {key: sum(r[key] * r["launches"] for r in rows) for key in ("ms", "plain_ms", "bound_ms")} | {
        "launches": sum(r["launches"] for r in rows)}


def graph_timer(fn, iters):
    """ms a call of ``fn``: ``iters`` calls captured in one CUDA graph, replayed between CUDA events.
    The device's time alone, as in a served forward, where the host runs ahead of the card: timed
    call by call, a launch of a few microseconds on the card reads the host's cost of the call."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(MODELS), default=None, help="default: segformer and transunet")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    print(f"card: {card}; torch {torch.__version__}; LayerNorm, bf16 x, f32 weight and bias; median of "
          f"{args.rounds} rounds in turns", flush=True)
    bad = []
    with torch.inference_mode():
        for model in [args.model] if args.model else ["segformer", "transunet"]:
            rows = measure(model, graph_timer, args.rounds, args.iters, gen)
            for r in rows:
                print(f"{model:9s} {r['label']:16s} {str(tuple(r['shape'])):20s} x{r['launches']:3d}  kernel "
                      f"{r['ms']:8.4f} ms  plain {r['plain_ms']:8.4f} ms  bound {r['bound_ms']:8.4f} ms "
                      f"({100 * r['bound_ms'] / r['ms']:5.1f}%)  ulps {r['ulps']:.3g} differing {r['differing']:.2e} "
                      f"err {r['err']:.3e} (plain {r['plain_err']:.3e}, ulp {r['ulp']:.3e}) ok {r['ok']}", flush=True)
                if not r["ok"]:
                    bad.append(f"{model} {r['label']}")
            for stage in sorted({r["label"].split(".")[0] for r in rows if "." in r["label"]}):
                t = totals(rows, stage + ".")
                print(f"{model}: {stage}'s {t['launches']} launches: kernel {t['ms']:.3f} ms  plain {t['plain_ms']:.3f} "
                      f"ms  bound {t['bound_ms']:.3f} ms", flush=True)
            t = totals(rows)
            print(f"{model}: a request's {t['launches']} launches: kernel {t['ms']:.3f} ms  plain {t['plain_ms']:.3f} ms "
                  f" bound {t['bound_ms']:.3f} ms ({100 * t['bound_ms'] / t['ms']:.1f}%) ({card})", flush=True)
            print(json.dumps({"model": model, "card": card, "totals": t, "rows": rows}))
    if bad:
        sys.exit(f"the kernel fails the numerics gates at: {bad}")


if __name__ == "__main__":
    main()
