#!/usr/bin/env python3
"""The pooled-attention kernels beside SDPA and their bound, on one GPU.

    python3 scripts/bench_torch_pooled_attention.py [--root DIR] [--batch 128] [--large_batch 1024]
        [--iters 20] [--seed 0] [--f32] [--configs]

``ops/pooled_attention.py::pooled_attention`` launches the kernel that
``entry_point`` names: in bf16 the wgmma kernel at every N; in f32 the 16-row
SIMT kernel that keeps its energies in shared memory (it takes N <= 1024) up to
``SHORT_TOKENS`` and the two-pass SIMT kernel above.  This script times the
bf16 kernel at the nineteen shapes of the models that run it (the flagship's
nine launches at N = 64, the bottleneck of pool 4, the full-resolution model's
nine at 64x64) at ``--batch`` one by one, and the flagship's nine as a group
of launches (the least of 5 readings of 20 rounds) at ``--batch``, where the
launches weigh, and at ``--large_batch``, where the kernel does; each beside
``F.scaled_dot_product_attention`` (scale 1.0) and the least time the card
could take: the largest of the bytes of q, k, v and out over 3.35 TB/s, the
operations over the peak for the type (989 TFLOP/s bf16 on the tensor cores,
67 f32 outside them) and the B*N*N exponentials over 132 SMs x 16 a clock x
the maximum SM clock.  It prints the registers and spills ptxas gave each
instance of the bf16 kernel, and one JSON line last.

``--root DIR`` times another checkout's package (e.g. a parent unpacked with
``git archive PARENT dfc_sa_unet_torch | tar -x -C DIR``): run parent, change,
change, parent in one call to compare two trees on one card.  ``--f32`` adds
both SIMT kernels wherever both run (by moving the wrapper's threshold).
``--configs`` builds the bf16 kernel's other configurations from the
checkout's source (csrc/pooled_attention.cu's templates: consumer warpgroups,
an image each or one image's rows shared, keys a chunk) and times them at the
shapes where the dispatch chooses among them.  Needs a CUDA card (and nvcc
for ``--configs``).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

# (label, N, C): the flagship's nine levels at pool 8, the bottleneck at pool 4, and the
# full-resolution model's nine levels at 64x64 (N = H*H); C' = C / 8
FLAGSHIP = [64, 128, 256, 512, 1024, 512, 256, 128, 64]
FULLRES = [(64, 64), (32, 128), (16, 256), (8, 512), (4, 1024), (8, 512), (16, 256), (32, 128), (64, 64)]
SHAPES = ([(f"flagship-{i}", 64, c) for i, c in enumerate(FLAGSHIP)] + [("pool4-bottleneck", 16, 1024)]
          + [(f"fullres-{i}", h * h, c) for i, (h, c) in enumerate(FULLRES)])
SHORT_KERNEL_MAX = 1024
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SMS, EXP_PER_CLOCK = 132, 16
# --configs: (Cq padded, C of a tile, consumer warpgroups, an image each (in turns on the tensor cores),
# keys a chunk) of the bf16 kernel, each timed at the shapes (N, Cq, C) where the dispatch chooses among them;
# the first of each list is the one it launches
CONFIGS = {
    (4096, 8, 64): [(16, 64, 3, False, 128), (16, 64, 3, False, 64), (16, 64, 2, False, 128)],
    (1024, 16, 128): [(16, 128, 2, False, 128), (16, 128, 2, False, 64), (16, 128, 3, False, 64)],
    (64, 128, 1024): [(128, 128, 2, True, 64), (128, 128, 2, False, 64)],
    (64, 8, 64): [(16, 64, 2, True, 64), (16, 64, 3, False, 128)],
}
CONFIG_BATCH = {4096: 128, 1024: 128, 64: 1024}


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


def with_threshold(ops, threshold, q, k, v, iters):
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


def ptxas_lines(log_path, kernel):
    """[(instance, 'N registers', spill line)] of ``kernel``'s instances in an nvcc -Xptxas -v log."""
    out, entry = [], None
    for ln in open(log_path, encoding="utf-8").read().splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1] if "'" in ln else ln
        elif entry and kernel in entry and "spill stores" in ln:
            out.append([entry, None, ln.split(":", 1)[-1].strip()])
        elif entry and kernel in entry and "Used" in ln and out and out[-1][0] == entry:
            out[-1][1] = ln.split("Used")[1].split(",")[0].strip()
    return out


def config_library(build_mod, root, configs, tmp):
    """A library of the checkout's csrc/pooled_attention.cu with one more export, ``config_bf16``, that
    launches the instantiation configs[i] of its bf16 kernel (the same ctypes arguments, then i)."""
    csrc = os.path.join(root, "dfc_sa_unet_torch", "csrc")
    cases = "\n".join(
        f"    case {i}: return launch_wg<{cqp}, {ct}, {nc}, {'true' if split else 'false'}, {ch}>"
        f"(q, k, v, out, b, nq, n, cq, c, stream);"
        for i, (cqp, ct, nc, split, ch) in enumerate(configs))
    src = open(os.path.join(csrc, "pooled_attention.cu"), encoding="utf-8").read() + f"""
extern "C" int config_bf16(const void* q, const void* k, const void* v, void* out, int b, int nq, int n, int cq,
                           int c, void* stream, int i) {{
  switch (i) {{
{cases}
  }}
  return static_cast<int>(cudaErrorInvalidValue);
}}
"""
    path, so = os.path.join(tmp, "configs.cu"), os.path.join(tmp, "libconfigs.so")
    open(path, "w", encoding="utf-8").write(src)
    subprocess.run([build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-I", csrc, "-o", so, path], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(so).config_bf16
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="the checkout whose dfc_sa_unet_torch is timed")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--large_batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--f32", action="store_true", help="also time the f32 SIMT kernels")
    ap.add_argument("--configs", action="store_true", help="also time the bf16 kernel's other configurations")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: scripts/bench_torch_pooled_attention.py times kernels on a GPU")
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from dfc_sa_unet_torch.ops import _build, pooled_attention as ops

    assert ops.__file__.startswith(root + os.sep), ops.__file__
    _build.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                           capture_output=True, text=True).stdout.split()
    if not clock:
        raise RuntimeError("nvidia-smi gave no maximum SM clock: the exponential bound needs it")
    sm_mhz = float(clock[0])
    bf16_name = ops.entry_point(torch.bfloat16, 64)
    print(f"card: {card}; maximum SM clock {sm_mhz:.0f} MHz; torch {torch.__version__}; {root}; pooled attention, "
          f"B={args.batch}; bf16: {bf16_name}; f32: the 16-row kernel up to N = {ops.SHORT_TOKENS}", flush=True)
    kernel = bf16_name.replace("_bf16", "_kernel")
    for inst, regs, spills in ptxas_lines(_build.BUILD_DIR / "pooled_attention.log", kernel):
        print(f"ptxas {inst}: {regs}, {spills}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    result = {"root": root, "card": card, "bf16": bf16_name, "batch": args.batch}

    def inputs(b, n, cq, c, dtype):
        return tuple(torch.randn(b, n, 1, ch, generator=gen, device="cuda").to(dtype) for ch in (cq, cq, c))

    with torch.inference_mode():
        for dtype in (torch.bfloat16, torch.float32) if args.f32 else (torch.bfloat16,):
            dn = str(dtype).split(".")[-1]
            sums, rows = {}, {}
            for label, n, c in SHAPES:
                q, k, v = inputs(args.batch, n, c // 8, c, dtype)
                qs, ks, vs = (t.reshape(args.batch, 1, n, -1) for t in (q, k, v))
                iters = max(3, args.iters // 4) if n == 4096 else args.iters
                sdpa = timed(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), iters)
                bound, by = bound_ms(args.batch, n, c, dtype, sm_mhz)
                if dtype == torch.bfloat16:
                    kern = timed(lambda: ops.pooled_attention(q, k, v), iters)
                    times = f"kernel {kern:8.4f} ms"
                else:
                    short = (with_threshold(ops, SHORT_KERNEL_MAX, q, k, v, iters) if n <= SHORT_KERNEL_MAX
                             else None)
                    kern = with_threshold(ops, 0, q, k, v, iters)
                    times = f"16-row {'     n/a' if short is None else f'{short:8.4f}'} ms  two-pass {kern:8.4f} ms"
                    kern = short if short is not None and n <= ops.SHORT_TOKENS else kern  # what the wrapper launches
                model = label.split("-")[0]
                acc = sums.setdefault(model, [0.0, 0.0, 0.0])
                acc[0] += kern
                acc[1] += sdpa
                acc[2] += bound
                rows[label] = {"ms": kern, "sdpa_ms": sdpa, "bound_ms": bound}
                print(f"{dn:8s} {label:18s} N={n:5d} C={c:5d}  {times}  SDPA {sdpa:8.4f} ms  "
                      f"bound {bound:7.4f} ms ({by})  ({card})", flush=True)
            for model in ("flagship", "fullres"):
                k_ms, s_ms, b_ms = sums[model]
                print(f"{dn:8s} {model}'s 9 launches: kernel {k_ms:.4f} ms  SDPA {s_ms:.4f} ms  bound {b_ms:.4f} ms  "
                      f"({card})", flush=True)
            result[dn] = {"shapes": rows, "sums": {m: dict(zip(("ms", "sdpa_ms", "bound_ms"), v))
                                                   for m, v in sums.items()}}
            del q, k, v, qs, ks, vs
        # the flagship's nine as a group of launches: the least of 5 readings of 20 rounds
        result["flagship_nine"] = {}
        for b in (args.batch, args.large_batch):
            nine_in = []
            for c in FLAGSHIP:
                q, k, v = inputs(b, 64, c // 8, c, torch.bfloat16)
                nine_in.append((q, k, v, *(t.reshape(b, 1, 64, -1) for t in (q, k, v))))
            nine = min(timed(lambda: [ops.pooled_attention(*t[:3]) for t in nine_in], 20) for _ in range(5))
            nine_sdpa = min(timed(lambda: [F.scaled_dot_product_attention(*t[3:], scale=1.0) for t in nine_in], 20)
                            for _ in range(5))
            nine_bound = sum(bound_ms(b, 64, c, torch.bfloat16, sm_mhz)[0] for c in FLAGSHIP)
            print(f"bfloat16 flagship's 9 launches as a group at B={b}: kernel {nine:.4f} ms  SDPA {nine_sdpa:.4f} ms  "
                  f"bound {nine_bound:.4f} ms  ({card})", flush=True)
            result["flagship_nine"][str(b)] = {"ms": nine, "sdpa_ms": nine_sdpa, "bound_ms": nine_bound}
            del nine_in

        if args.configs:
            configs = [cfg for cfgs in CONFIGS.values() for cfg in cfgs]
            with tempfile.TemporaryDirectory() as tmp:
                fn = config_library(_build, root, configs, tmp)
                result["configs"] = []
                for (n, cq, c), cfgs in CONFIGS.items():
                    b = CONFIG_BATCH[n]
                    q, k, v = inputs(b, n, cq, c, torch.bfloat16)
                    out = torch.empty_like(v)
                    want = ops.pooled_attention_plain(q[:2], k[:2], v[:2]).float()
                    stream = _build.stream_handle(q.device)
                    for cfg in cfgs:
                        i = configs.index(cfg)

                        def run():
                            _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, n, cq, c,
                                            stream, i), "config_bf16")

                        ms = min(timed(run, max(3, args.iters // 4) if n == 4096 else args.iters) for _ in range(2))
                        err = (out[:2].float() - want).abs().max().item()
                        keys = ("cq_padded", "c_tile", "consumers", "image_each", "chunk")
                        print(f"config B={b} N={n} Cq={cq} C={c} {dict(zip(keys, cfg))}: {ms:.4f} ms  "
                              f"max_abs_err {err:.3e}  ({card})", flush=True)
                        result["configs"].append({"batch": b, "n": n, "cq": cq, "c": c, **dict(zip(keys, cfg)),
                                                  "ms": ms, "max_abs_err": err})
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
