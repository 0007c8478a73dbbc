#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dfc_sa_unet_torch) on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Run from the root of the repository.  Phases, each printing its lines;
any failure exits non-zero:

1. require CUDA; print the card's name and power limit; turn TF32 off
   for the f32 checks;
2. build the CUDA kernels from dfc_sa_unet_torch/csrc;
3. hold every kernel against its plain PyTorch version on the card, at
   the shapes the main paths give it and at awkward ones, in f32 and bf16;
4. serve the flagship DFC-SA-Res-Block at full width (224x224, features
   64/128/256/512, pool 8, seeded weights, BatchNorm statistics fitted to
   a slice of the batch so that the logits spread O(1)):
   one B=128 uint8 batch through the Predictor on the module path
   (attention kernel) and through the folded DFCEngine (tail kernel on the
   7 "auto" levels, 3x3 conv kernel on the other two, attention kernel on
   all 9); the probabilities must agree, and the launch counts show that
   the kernels ran;
5. three synthetic 512x512 requests through predict_sliding_stream(tta);
6. serve the transformer zoo at full width and depth (224x224, ViT-B:
   E=768, 12 heads, 12 layers, MLP 3072; TransUNet: R50 units (3,4,9), the
   same ViT-B, DecoderCup), seeded weights with fitted BatchNorm
   statistics: one B=128 uint8 batch through the Predictor in f32 and
   bf16.  ViT-seg must launch the fused_mha kernel 12 times per forward
   and TransUNet the fused_mha_sep kernel 12 times; f32 on the card must
   agree with the same weights on the CPU, and bf16 with f32;
7. time each kernel, its plain version, a library yardstick and every
   serving path in bf16 at B=128.

The launch counts are set to 0 before phase 4 and read after phase 5 (the
flagship's paths), and again around phase 6 (the transformers' paths).
The line before the last is a JSON object of the kernels; the last line is
{"ok": true, "device": {...}}.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

BATCH = 128
IMG = 224
# configs/config_dfc-sa-res-block.yaml, model section (no YAML reader needed)
CONFIG = {"model": {"name": "DFC-SA-Res-Block", "in_channels": 3, "out_channels": 1,
                    "features": [64, 128, 256, 512], "pool_size": 8, "use_pallas": True}}
# (block, H, Cin, C) of the flagship at 224x224
# configs/config_vit_seg.yaml and configs/config_transunet.yaml: the model section, and the
# dataset's image size, which sizes TransUNet
ZOO = {
    "ViT-seg": ({"model": {"name": "VisionTransformerSegmentation", "in_channels": 3, "out_channels": 1,
                           "img_dim": 224, "patch_dim": 16, "embed_dim": 768, "num_layers": 12,
                           "num_heads": 12, "mlp_dim": 3072, "dropout": 0.1}}, "fused_mha"),
    "TransUNet": ({"model": {"name": "TransformerUNet", "in_channels": 3, "out_channels": 1},
                   "dataset": {"img_size": [224, 224]}}, "fused_mha_sep"),
}
TOKENS, EMBED, HEADS, LAYERS = 196, 768, 12, 12  # ViT-B/16 at 224x224: what both models give the kernel
BLOCK_SHAPES = [("down1", 224, 3, 64), ("down2", 112, 64, 128), ("down3", 56, 128, 256),
                ("down4", 28, 256, 512), ("bottleneck", 14, 512, 1024),
                ("up_conv4", 28, 1024, 512), ("up_conv3", 56, 512, 256),
                ("up_conv2", 112, 256, 128), ("up_conv1", 224, 128, 64)]
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
PEAK_OPS = {"bf16": 989e12, "f32": 67e12}  # dense tensor-core bf16; f32 without tensor cores
TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # max |kernel - plain| <= TOL * max(1, max|plain|)
# module path vs engine path in f32: |dprob| <= 1e-3 and |dlogit| <= 1e-2 * std(logit); the
# engine folds BatchNorm into the weights, which reorders the f32 sums of every conv
PROB_TOL_F32 = 1e-3
# bf16 engine vs bf16 module on a request, in units of std(logit): the two round at different
# places (folded weights vs f32 BatchNorm), a few bf16 ulps through 9 blocks
DLOGIT_TOL_BF16 = {"mean": 0.05, "max": 0.5}
MIN_LOGIT_STD = 0.1  # below this the agreement checks could not tell a constant output apart
# transformer f32 on the card vs the same weights on the CPU (plain attention), max |dlogit| / std:
# the same f32 arithmetic in another order through 12 layers
DLOGIT_TOL_CPU = 1e-3
# transformer bf16 vs f32 on the card, |dlogit| / std.  ViT-seg keeps the limits above (it read
# mean 8.4e-3, max 7.3e-2).  TransUNet needs wider ones: with seeded weights the bf16 roundings of
# the 48 weight-standardised convs of its R50 add up without contracting (mean 0.26 of the
# activation std after block3 at a reduced size on the CPU, and the JAX package's own bf16 mode reads
# the same there); the full model read mean 1.250e-01 and max 1.255 on an H100.  A constant output
# reads about 0.8 on the mean.
DLOGIT_TOL_BF16_ZOO = {"ViT-seg": DLOGIT_TOL_BF16, "TransUNet": {"mean": 0.25, "max": 2.5}}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def logit_of(p):
    return np.log(np.clip(p, 1e-7, 1 - 1e-7) / np.clip(1 - p, 1e-7, 1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    seed = ap.parse_args().seed

    # ------------------------------------------------------------ phase 1
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available: chip_smoke.py needs an H100")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import dfc_sa_unet_torch  # noqa: F401
    except ImportError as e:
        fail(f"dfc_sa_unet_torch is not beside chip_smoke.py ({e})")
    from dfc_sa_unet_torch.infer.engine import AUTO_TAIL_LEVELS, DFCEngine
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.models.factory import create_model
    from dfc_sa_unet_torch.ops import _build, launches, reset_launches
    from dfc_sa_unet_torch.ops import dfc_tail as tail_ops, mha as mha_ops, pooled_attention as attn_ops
    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, init_random_

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "nvidia-smi gave nothing"
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)

    # ------------------------------------------------------------ phase 2
    t0 = time.perf_counter()
    _build.build()
    print(f"[2] built {sorted(p.name for p in _build.BUILD_DIR.glob('*.so'))} "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        regs = [ln.split("Used")[1].split(",")[0].strip() for ln in log.read_text().splitlines() if "Used" in ln]
        spills = sum("0 bytes spill stores" not in ln for ln in log.read_text().splitlines() if "spill stores" in ln)
        print(f"    {log.stem}: registers per kernel instance {regs}; instances with spills: {spills}")

    # ------------------------------------------------------------ phase 3
    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    def attn_inputs(b, n, c, dtype):
        return (randn(b, n, 1, c // 8, dtype=dtype), randn(b, n, 1, c // 8, dtype=dtype),
                randn(b, n, 1, c, dtype=dtype))

    def conv_inputs(b, h, cin, c, dtype):
        return (randn(b, h, h, cin, dtype=dtype), randn(3, 3, cin, c, dtype=dtype, scale=(9 * cin) ** -0.5),
                randn(c))

    def tail_inputs(b, h, cin, c, dtype):
        x, wc, bc = conv_inputs(b, h, cin, c, dtype)
        return (x, randn(b, h, h, c, dtype=dtype), wc, bc, randn(2 * c, c, dtype=dtype, scale=(2 * c) ** -0.5),
                randn(c), randn(3 * c, c, dtype=dtype, scale=(3 * c) ** -0.5), randn(c),
                randn(cin, c, dtype=dtype, scale=0.1 * cin ** -0.5))

    def mha_inputs(b, n, e, dtype, packed):
        qkv = randn(b, n, 3 * e, dtype=dtype)
        return (qkv,) if packed else tuple(t.contiguous() for t in qkv.chunk(3, dim=-1))

    max_err = {"pooled_attention": 0.0, "dfc_tail": 0.0, "conv3x3_bn_relu": 0.0, "fused_mha": 0.0,
               "fused_mha_sep": 0.0}
    bad = []

    def check(name, kernel, plain, args, label):
        got = kernel(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        scale = max(1.0, want.float().abs().max().item())
        tol = TOL[str(args[0].dtype).split(".")[-1]] * scale
        ok = bool(np.isfinite(err)) and err <= tol and got.shape == want.shape
        max_err[name] = max(max_err[name], err)
        print(f"    {name:16s} {label:38s} max_abs_err {err:.3e} (rel {err / scale:.2e}) "
              f"tol {tol:.2e} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(f"{name} {label}")

    print("[3] kernels vs plain PyTorch on the card", flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for c in (64, 128, 256, 512, 1024):
            check("pooled_attention", attn_ops.pooled_attention, attn_ops.pooled_attention_plain,
                  attn_inputs(BATCH, 64, c, dtype), f"{dn} B={BATCH} N=64 C={c}")
        for n in (16, 256, 1024):
            check("pooled_attention", attn_ops.pooled_attention, attn_ops.pooled_attention_plain,
                  attn_inputs(16, n, 256, dtype), f"{dn} B=16 N={n} C=256")
        for name, h, cin, c in BLOCK_SHAPES:
            label = f"{dn} {name} B=4 {h}x{h} {cin}->{c}"
            if name in AUTO_TAIL_LEVELS:
                check("dfc_tail", tail_ops.dfc_tail, tail_ops.dfc_tail_plain,
                      tail_inputs(4, h, cin, c, dtype), label)
            check("conv3x3_bn_relu", tail_ops.conv3x3_bn_relu, tail_ops.conv3x3_bn_relu_plain,
                  conv_inputs(4, h, cin, c, dtype), label)
        # the ViT-B shape of both models, then awkward ones: a tiny N, N not a multiple of 8,
        # the largest N, a single image
        for b, n, e, nh in ((BATCH, TOKENS, EMBED, HEADS), (2, 16, 32, 2), (3, 197, EMBED, HEADS),
                            (2, 1024, 128, 4), (1, TOKENS, EMBED, HEADS)):
            label = f"{dn} B={b} N={n} E={e} heads={nh}"
            check("fused_mha", mha_ops.fused_mha, mha_ops.fused_mha_plain,
                  (*mha_inputs(b, n, e, dtype, packed=True), nh), label)
            check("fused_mha_sep", mha_ops.fused_mha_sep, mha_ops.fused_mha_sep_plain,
                  (*mha_inputs(b, n, e, dtype, packed=False), nh), label)
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")

    # ------------------------------------------------------------ phase 4
    print(f"[4] flagship DFC-SA-Res-Block at {IMG}x{IMG}, B={BATCH}, seed {seed}", flush=True)
    rng = np.random.default_rng(seed)
    batch = rng.integers(0, 256, (BATCH, IMG, IMG, 3), dtype=np.uint8)
    cpu_model = init_random_(create_model(CONFIG, device="cpu"), torch.Generator().manual_seed(seed))
    model = cpu_model.to(dev, memory_format=torch.channels_last)
    calib = normalize(torch.from_numpy(batch[:16]).to(dev), torch.float32).permute(0, 3, 1, 2)
    weights = calibrate_batch_stats_(model, calib).state_dict()

    def serving(dtype, engine):
        if engine:
            fwd = DFCEngine(CONFIG, weights, dtype=dtype, device=dev, tail_kernel_levels="auto",
                            conv_kernel_levels="auto")
        else:
            fwd = create_model(CONFIG, dtype=None if dtype == torch.float32 else dtype, device=dev)
            fwd.load_state_dict(weights, strict=True)
        return Predictor(fwd, compute_dtype=dtype, device=dev)

    none = {name: 0 for name in max_err}
    per_forward = {"module": {**none, "pooled_attention": 9},
                   "engine": {**none, "pooled_attention": 9, "dfc_tail": 7, "conv3x3_bn_relu": 2}}
    reset_launches()  # the flagship's main path starts here (phases 4 and 5)
    probs = {}
    for kind in ("module", "engine"):
        before = launches()
        with torch.inference_mode():
            probs[kind] = serving(torch.float32, kind == "engine").predict_probs(batch)
        delta = {k: v - before[k] for k, v in launches().items()}
        print(f"    {kind} f32: probs {probs[kind].shape}, launches {delta}", flush=True)
        if delta != per_forward[kind]:
            fail(f"{kind} forward launched {delta}, expected {per_forward[kind]}")
        if probs[kind].shape != (BATCH, IMG, IMG) or not np.isfinite(probs[kind]).all():
            fail(f"{kind} probabilities: shape {probs[kind].shape} or non-finite values")
    diff = float(np.abs(probs["module"] - probs["engine"]).max())
    logit = {k: logit_of(p) for k, p in probs.items()}
    dlogit = float(np.abs(logit["module"] - logit["engine"]).max())
    print(f"    module vs engine (f32): max |dprob| {diff:.3e} (tol {PROB_TOL_F32}); max |dlogit| "
          f"{dlogit:.3e} against logit std {logit['module'].std():.3e}, range "
          f"[{logit['module'].min():.3f}, {logit['module'].max():.3f}]", flush=True)
    logit_std = float(logit["module"].std())
    if logit_std < MIN_LOGIT_STD:
        fail(f"logit std {logit_std:.3e} < {MIN_LOGIT_STD}: the output hardly depends on the input")
    if not (diff <= PROB_TOL_F32 and dlogit <= 1e-2 * logit_std):
        fail("module and engine outputs disagree")

    # ------------------------------------------------------------ phase 5
    pred_engine = serving(torch.bfloat16, engine=True)
    pred_module = serving(torch.bfloat16, engine=False)
    requests = [(f"req{i}", rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)) for i in range(3)]
    t0 = time.perf_counter()
    with torch.inference_mode():
        served = list(pred_engine.predict_sliding_stream(iter(requests), tta=True))
        ref = pred_module.predict_sliding(requests[0][1], tta=True)
    torch.cuda.synchronize()
    print(f"[5] {len(served)} requests of 512x512 with TTA through the bf16 engine in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for (key, p), (want_key, _) in zip(served, requests):
        if key != want_key or p.shape != (512, 512) or not np.isfinite(p).all() or p.min() < 0 or p.max() > 1:
            fail(f"request {want_key}: got key {key}, shape {p.shape}")
    req_logit = [logit_of(p) for p in (served[0][1], ref)]
    req_std = float(req_logit[1].std())
    req_diff = np.abs(req_logit[0] - req_logit[1]) / req_std
    print(f"    bf16 engine vs bf16 module on req0: logit std {req_std:.3e}; |dlogit| / std: max "
          f"{req_diff.max():.3e} (tol {DLOGIT_TOL_BF16['max']}), mean {req_diff.mean():.3e} "
          f"(tol {DLOGIT_TOL_BF16['mean']})", flush=True)
    if req_std < MIN_LOGIT_STD:
        fail(f"request logit std {req_std:.3e} < {MIN_LOGIT_STD}")
    if not (req_diff.max() <= DLOGIT_TOL_BF16["max"] and req_diff.mean() <= DLOGIT_TOL_BF16["mean"]):
        fail("bf16 engine and module disagree on a request")
    main_launches = launches()  # the flagship's main path ends here
    print(f"    flagship main-path launches: {main_launches}", flush=True)
    if min(main_launches[k] for k in ("pooled_attention", "dfc_tail", "conv3x3_bn_relu")) < 1:
        fail(f"a kernel of the flagship's main path never launched: {main_launches}")

    # ------------------------------------------------------------ phase 6
    print(f"[6] transformer zoo at {IMG}x{IMG}, B={BATCH}, seed {seed}", flush=True)
    reset_launches()  # the transformers' main path starts here
    zoo_pred = {}
    for label, (cfg, kernel_name) in ZOO.items():
        zoo_model = init_random_(create_model(cfg, device="cpu"), torch.Generator().manual_seed(seed))
        zoo_model = zoo_model.to(dev, memory_format=torch.channels_last)
        zoo_weights = calibrate_batch_stats_(zoo_model, calib).state_dict()
        del zoo_model
        zoo_probs = {}
        for dtype in (torch.float32, torch.bfloat16):
            dn = str(dtype).split(".")[-1]
            fwd = create_model(cfg, dtype=None if dtype == torch.float32 else dtype, device=dev)
            fwd.load_state_dict(zoo_weights, strict=True)
            pred = Predictor(fwd, compute_dtype=dtype, device=dev)
            before = launches()
            with torch.inference_mode():
                zoo_probs[dn] = pred.predict_probs(batch)
            delta = {k: v - before[k] for k, v in launches().items()}
            print(f"    {label} {dn}: probs {zoo_probs[dn].shape}, launches {delta}", flush=True)
            if delta != {**none, kernel_name: LAYERS}:
                fail(f"{label} forward launched {delta}, expected {LAYERS} of {kernel_name} alone")
            if zoo_probs[dn].shape != (BATCH, IMG, IMG) or not np.isfinite(zoo_probs[dn]).all():
                fail(f"{label} {dn} probabilities: shape {zoo_probs[dn].shape} or non-finite values")
        zoo_pred[label] = pred  # the bf16 predictor, timed in phase 7
        cpu_fwd = create_model(cfg, device="cpu")
        cpu_fwd.load_state_dict(zoo_weights, strict=True)
        with torch.inference_mode():
            cpu_probs = Predictor(cpu_fwd, device="cpu").predict_probs(batch[:4])
        zl = {k: logit_of(p) for k, p in zoo_probs.items()}
        zstd = float(zl["float32"].std())
        d_cpu = float(np.abs(zl["float32"][:4] - logit_of(cpu_probs)).max()) / zstd
        d_bf16 = np.abs(zl["bfloat16"] - zl["float32"]) / zstd
        tol_bf16 = DLOGIT_TOL_BF16_ZOO[label]
        print(f"    {label}: logit std {zstd:.3e}, range [{zl['float32'].min():.3f}, {zl['float32'].max():.3f}]; "
              f"f32 card vs CPU on 4 images max |dlogit| / std {d_cpu:.3e} (tol {DLOGIT_TOL_CPU}); bf16 vs f32 "
              f"|dlogit| / std: max {d_bf16.max():.3e} (tol {tol_bf16['max']}), mean "
              f"{d_bf16.mean():.3e} (tol {tol_bf16['mean']})", flush=True)
        if zstd < MIN_LOGIT_STD:
            fail(f"{label} logit std {zstd:.3e} < {MIN_LOGIT_STD}: the output hardly depends on the input")
        if not d_cpu <= DLOGIT_TOL_CPU:
            fail(f"{label}: f32 on the card and on the CPU disagree")
        if not (d_bf16.max() <= tol_bf16["max"] and d_bf16.mean() <= tol_bf16["mean"]):
            fail(f"{label}: bf16 and f32 disagree on the card")
        del cpu_fwd, fwd, zoo_weights
    zoo_launches = launches()  # the transformers' main path ends here
    print(f"    transformer main-path launches: {zoo_launches}", flush=True)
    if min(zoo_launches[k] for k in ("fused_mha", "fused_mha_sep")) < 1:
        fail(f"a kernel of the transformers' main path never launched: {zoo_launches}")
    main_launches = {k: main_launches[k] + zoo_launches[k] for k in main_launches}

    # ------------------------------------------------------------ phase 7
    print(f"[7] timings, bf16, B={BATCH} ({card})", flush=True)

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

    import torch.nn.functional as F

    bf = torch.bfloat16
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "ops": 0.0}
            for k in max_err}

    def add(name, level, ms, plain_ms, lib_ms, nbytes, ops):
        r = rows[name]
        r["ms"] += ms
        r["plain_ms"] += plain_ms
        r["library_ms"] += lib_ms
        r["bytes"] += nbytes
        r["ops"] += ops
        bound = max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS["bf16"]) * 1e3
        print(f"    {name:16s} {level:10s} kernel {ms:8.3f} ms  plain {plain_ms:8.3f} ms  "
              f"library {lib_ms:8.3f} ms  bound {bound:7.3f} ms", flush=True)

    with torch.inference_mode():
        for name, h, cin, c in BLOCK_SHAPES:
            q, k, v = attn_inputs(BATCH, 64, c, bf)
            qs, ks, vs = (t.reshape(BATCH, 1, 64, -1) for t in (q, k, v))
            add("pooled_attention", name,
                timed(lambda: attn_ops.pooled_attention(q, k, v), 20),
                timed(lambda: attn_ops.pooled_attention_plain(q, k, v), 20),
                timed(lambda: F.scaled_dot_product_attention(qs, ks, vs, scale=1.0), 20),
                2 * (2 * q.numel() + 2 * v.numel()),
                2 * BATCH * 64 * 64 * (c // 8 + c))
        for name, h, cin, c in BLOCK_SHAPES:
            npix = BATCH * h * h
            if name in AUTO_TAIL_LEVELS:
                args = tail_inputs(BATCH, h, cin, c, bf)
                x, a = args[0], args[1]
                xc, ac = x.permute(0, 3, 1, 2), a.permute(0, 3, 1, 2)  # channels_last NCHW views
                kc = args[2].permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                kg = args[4].t().reshape(c, 2 * c, 1, 1).contiguous()
                kf = args[6].t().reshape(c, 3 * c, 1, 1).contiguous()
                kr = args[8].t().reshape(c, cin, 1, 1).contiguous()

                def library_tail():
                    local = F.relu(F.conv2d(xc, kc, args[3].to(bf), padding=1))
                    g = torch.sigmoid(F.conv2d(torch.cat([local, ac], 1), kg, args[5].to(bf)))
                    fused = g * local + (1 - g) * ac
                    o = F.relu(F.conv2d(torch.cat([fused, local, ac], 1), kf, args[7].to(bf)))
                    return o + F.conv2d(xc, kr)

                wbytes = 2 * (9 * cin * c + 5 * c * c + cin * c) + 4 * 3 * c
                add("dfc_tail", name,
                    timed(lambda: tail_ops.dfc_tail(*args), 3),
                    timed(lambda: tail_ops.dfc_tail_plain(*args), 3),
                    timed(library_tail, 3),
                    2 * npix * (cin + 2 * c) + wbytes,
                    2 * npix * c * (9 * cin + 5 * c + cin))
            else:
                x, w, b = conv_inputs(BATCH, h, cin, c, bf)
                xc = x.permute(0, 3, 1, 2)
                kc = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
                add("conv3x3_bn_relu", name,
                    timed(lambda: tail_ops.conv3x3_bn_relu(x, w, b), 3),
                    timed(lambda: tail_ops.conv3x3_bn_relu_plain(x, w, b), 3),
                    timed(lambda: F.relu(F.conv2d(xc, kc, b.to(bf), padding=1)), 3),
                    2 * npix * (cin + c) + 2 * 9 * cin * c + 4 * c,
                    2 * npix * c * 9 * cin)

        # one forward of either transformer launches its kernel LAYERS times at this shape
        head_dim = EMBED // HEADS
        mha_bytes = LAYERS * 2 * 4 * BATCH * TOKENS * EMBED
        mha_ops_count = LAYERS * 4 * BATCH * HEADS * TOKENS * TOKENS * head_dim
        for name, packed in (("fused_mha", True), ("fused_mha_sep", False)):
            args = mha_inputs(BATCH, TOKENS, EMBED, bf, packed)
            kernel, plain = ((mha_ops.fused_mha, mha_ops.fused_mha_plain) if packed
                             else (mha_ops.fused_mha_sep, mha_ops.fused_mha_sep_plain))
            q4, k4, v4 = (t.reshape(BATCH, TOKENS, HEADS, head_dim).transpose(1, 2)
                          for t in (args[0].chunk(3, dim=-1) if packed else args))

            def layers_of(fn):
                for _ in range(LAYERS):
                    fn()

            add(name, f"{LAYERS} launches",
                timed(lambda: layers_of(lambda: kernel(*args, HEADS)), 5),
                timed(lambda: layers_of(lambda: plain(*args, HEADS)), 3),
                timed(lambda: layers_of(lambda: F.scaled_dot_product_attention(q4, k4, v4)), 5),
                mha_bytes, mha_ops_count)

        xs = torch.from_numpy(batch).to(dev)
        for kind, pred in (("module", pred_module), ("engine", pred_engine), *zoo_pred.items()):
            xn = normalize(xs, bf).permute(0, 3, 1, 2)
            fwd_ms = timed(lambda: pred.model(xn), 3)
            t0 = time.perf_counter()
            for _ in range(3):
                pred.predict_probs(batch)
            serve_s = (time.perf_counter() - t0) / 3
            print(f"    {kind} path bf16: forward {fwd_ms:.2f} ms = {BATCH / fwd_ms * 1e3:.1f} img/s on device; "
                  f"predict_probs (uint8 in, probs out) {BATCH / serve_s:.1f} img/s ({card})", flush=True)

    sources = {"pooled_attention": ("dfc_sa_unet_torch/csrc/pooled_attention.cu",
                                    "dfc_sa_unet_tpu/ops/pallas_attention.py:74"),
               "dfc_tail": ("dfc_sa_unet_torch/csrc/dfc_tail.cu", "dfc_sa_unet_tpu/ops/pallas_conv.py:198"),
               "conv3x3_bn_relu": ("dfc_sa_unet_torch/csrc/dfc_tail.cu", "dfc_sa_unet_tpu/ops/pallas_conv.py:121"),
               "fused_mha": ("dfc_sa_unet_torch/csrc/mha.cu", "dfc_sa_unet_tpu/ops/pallas_attention.py:214"),
               "fused_mha_sep": ("dfc_sa_unet_torch/csrc/mha.cu", "dfc_sa_unet_tpu/ops/pallas_attention.py:276")}
    kernels = []
    for name, r in rows.items():
        by_bytes = r["bytes"] / HBM_BYTES_PER_S >= r["ops"] / PEAK_OPS["bf16"]
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": max(r["bytes"] / HBM_BYTES_PER_S, r["ops"] / PEAK_OPS["bf16"]) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations", "library_ms": r["library_ms"],
        })
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
