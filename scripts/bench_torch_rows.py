#!/usr/bin/env python3
"""Row (spatial) sharding across cards over NCCL: one process a card, each holding a band of every
image's rows, against one process on the whole image.

    python3 -m torch.distributed.run --standalone --nproc_per_node N scripts/bench_torch_rows.py \\
        [--model flagship] [--side 2048] [--reps 3] [--seed 0]

N cards (2 or more, even).  Serving: for S = 2 and, where N allows it, S = N (each S whose bands
keep the model's band rule, ``parallel.rows.divides``), the processes form a serving mesh of N / S
data groups of S bands (``parallel.mesh.spatial_subgroups``, NCCL: the halos move on the cards by
``batch_isend_irecv``, the token maps and keys by ``all_gather_into_tensor``), and each data group
serves a request of its own, the Predictor cutting the band and gathering the probabilities; every
rank first serves its request alone on its card, the one-process reference.  ``--model``:
``flagship`` (default: one ``--side`` x ``--side`` image through the flagship's bf16 engine, "auto"
levels), or one of chip_smoke phase 17's (``ViT-B/16``, ``R50-ViT-B/16``, ``UNet_FullResAttention``,
``UNet bilinear``: 8 images at their size through the bf16 module; ``int8 flagship`` on the
``--side`` image, ``int8 ViT-B/16``, ``int8 R50-ViT-B/16``: the bf16 int8 engines, calibrated at max
|t| on the same 8 synthetic images in every process); seeded weights with fitted BatchNorm
statistics, broadcast from rank 0.  Agreement: the bf16 probabilities at chip_smoke phase 5's
limits (phase 17's per model), the f32 logits (of the f32 module, the f32 engine, or the f32 int8
flagship with the same scales; none for the int8 transformers) as phase 17 holds them: within 1e-5 of
max |logit| (R50-ViT-B/16 within its own ``ROWS17_F32_TOL``), the int8 flagship's within phase 13's
limits.  Times: the request's wall time (host clock, median of
``--reps`` after one warm-up) and peak allocated memory, banded and alone.  Training (the flagship,
``UNet_FullResAttention``, ``UNet bilinear``): an f32 step at the model's size over the grid N / 2 x 2 (two bands), global
batch 2 N, 3 steps, against one process (each rank trains the whole batch alone on its card first;
the transformers, whose dropout a process alone seeds apart from a group's, are not trained here),
losses and state at chip_smoke phase 14(b)'s limits, ms/step beside one process's.  Prints a line
per check and last one JSON line of every number; exits non-zero on a disagreement.  Needs N CUDA
cards; build the kernels first (``python3 -c 'from dfc_sa_unet_torch.ops import _build;
_build.build()'``), so that the ranks load them.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from dfc_sa_unet_torch.data.normalize import normalize  # noqa: E402
from dfc_sa_unet_torch.data.synthetic import samples  # noqa: E402
from dfc_sa_unet_torch.infer.engine import DFCEngine  # noqa: E402
from dfc_sa_unet_torch.infer.quant import Int8DFCEngine  # noqa: E402
from dfc_sa_unet_torch.infer.quant_transunet import Int8TransUNetEngine  # noqa: E402
from dfc_sa_unet_torch.infer.quant_vit import Int8ViTEngine  # noqa: E402
from dfc_sa_unet_torch.infer.predictor import Predictor  # noqa: E402
from dfc_sa_unet_torch.models.factory import create_model  # noqa: E402
from dfc_sa_unet_torch.ops import launches, reset_launches  # noqa: E402
from dfc_sa_unet_torch.parallel import multihost as mh, rows  # noqa: E402
from dfc_sa_unet_torch.parallel.mesh import data_parallel_mesh, spatial_subgroups  # noqa: E402
from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, init_random_  # noqa: E402

TRAIN_STEPS = 3


MODELS = ("flagship", *smoke.ROWS17_MODELS, *smoke.ROWS17_INT8)
# the models whose training the bench holds to one process: those without dropout (a process alone
# seeds its masks apart from a group's; chip_smoke phase 17(c) holds the transformers through a group
# of one), and not the int8 engines, which serve only
TRAINED = ("flagship", "UNet_FullResAttention", "UNet bilinear")


def model_of(name, weights, dev, dtype, act_scales=None):
    """The serving callable of ``--model`` ``name`` in ``dtype`` (bf16 or f32), or None (no f32 path)."""
    bf = dtype == torch.bfloat16
    if name == "flagship":
        return DFCEngine(smoke.CONFIG, weights, dtype=dtype, device=dev, tail_kernel_levels="auto",
                         conv_kernel_levels="auto")
    if name in smoke.ROWS17_MODELS:
        model = create_model(smoke.ROWS17_MODELS[name][0], dtype=dtype if bf else None, device=dev)
        model.load_state_dict(weights)
        return model.eval()
    source = smoke.ROWS17_INT8[name][0]
    if source != "flagship" and not bf:
        return None
    synthetic = np.stack([img for _, img, _ in samples(n=smoke.INT8_CALIB_IMAGES, size=smoke.IMG, seed=0)])
    kw = dict(dtype=dtype, device=dev)
    kw.update(act_scales=act_scales) if act_scales is not None else kw.update(
        calib_batches=[normalize(torch.from_numpy(synthetic).to(dev), dtype).permute(0, 3, 1, 2)])
    with torch.inference_mode():
        if source == "flagship":
            return Int8DFCEngine(smoke.CONFIG, weights, tail_kernel_levels="auto", conv_kernel_levels="auto", **kw)
        if source == "ViT-B/16":
            return Int8ViTEngine(smoke.ZOO["ViT-seg"][0], weights, **kw)
        return Int8TransUNetEngine(smoke.ZOO["TransUNet"][0], weights, **kw)


def serve(weights, image, dev, mesh, reps, name="flagship"):
    """(probs, f32 logits or None, median ms, peak GiB, launches of one bf16 request) of ``image``
    through model ``name``'s bf16 Predictor (banded over ``mesh`` when it has a spatial axis) and its
    f32 path."""
    model = model_of(name, weights, dev, torch.bfloat16)
    scales = getattr(model, "act_scales", None)
    pred = Predictor(model, compute_dtype=torch.bfloat16, device=dev, mesh=mesh)
    with torch.inference_mode():
        pred.predict_probs(image)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(reps):
            dist.barrier()
            reset_launches()
            t0 = time.perf_counter()
            probs = pred.predict_probs(image)
            ms.append((time.perf_counter() - t0) * 1e3)
            counts = {k: v for k, v in launches().items() if v}
        peak = torch.cuda.max_memory_allocated() / 2**30
    del pred, model
    engine = model_of(name, weights, dev, torch.float32, scales)
    logits = None
    if engine is not None:
        band = None if mesh is None or mesh.spatial == 1 else mesh.band(image.shape[1])
        x = normalize(torch.from_numpy(image[:smoke.ROWS17_F32_IMAGES]).to(dev), torch.float32).permute(0, 3, 1, 2)
        logits = smoke.band_logits(engine, x, band)
    del engine
    torch.cuda.empty_cache()
    return probs, logits, float(np.median(ms)), peak, counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="flagship", choices=MODELS)
    ap.add_argument("--side", type=int, default=2048, help="the flagship's (and the int8 flagship's) image side")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = data_parallel_mesh()  # torchrun's environment, NCCL, cuda:LOCAL_RANK
    dev, n = mesh.device, mesh.world_size
    if n < 2 or n % 2:
        sys.exit(f"needs an even number of processes, one a card; got {n}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    out = {"card": card, "processes": n, "serving": [], "training": None}
    bad = []
    source = smoke.ROWS17_INT8[args.model][0] if args.model in smoke.ROWS17_INT8 else args.model
    if source == "flagship":
        cfg, side, images = smoke.CONFIG, args.side, 1
    else:
        cfg, side, images = smoke.ROWS17_MODELS[source][0], smoke.ROWS17_MODELS[source][1], smoke.ROWS17_IMAGES
    lim = smoke.ROWS17_TOL.get(args.model, smoke.DLOGIT_TOL_BF16)
    try:
        model = init_random_(create_model(cfg, device="cpu"), torch.Generator().manual_seed(args.seed)).to(dev)
        calib_side = smoke.IMG if source == "flagship" else side
        calib = np.random.default_rng(args.seed).integers(0, 256, (16, calib_side, calib_side, 3), dtype=np.uint8)
        calibrate_batch_stats_(model, normalize(torch.from_numpy(calib).to(dev)).permute(0, 3, 1, 2))
        weights = mh.broadcast_tree({k: v.detach() for k, v in model.state_dict().items()})  # rank 0's everywhere
        del model
        # every model here spans 16 rows a row of its coarsest grid (ViT-B/16's patch, the others' /16)
        for spatial in sorted(s for s in {2, n} if rows.divides(side, s)):
            spatial_subgroups(mesh, spatial)
            image = np.random.default_rng(args.seed + mesh.data_index).integers(
                0, 256, (images, side, side, 3), dtype=np.uint8)
            alone = serve(weights, image, dev, None, args.reps, args.model)
            banded = serve(weights, image, dev, mesh, args.reps, args.model)
            want = smoke.logit_of(alone[0])
            d = np.abs(smoke.logit_of(banded[0]) - want) / want.std()
            # the f32 logits against one process, as chip_smoke phase 17 holds them
            if alone[1] is None:
                f32, unit, f32_ok = float("nan"), "", True
            elif args.model == "int8 flagship":  # phase 13's limits, in units of the logit std
                dl = np.abs(banded[1] - alone[1]) / alone[1].std()
                f32, unit = float(dl.max()), "max |dlogit| / std"
                f32_ok = dl.max() <= smoke.DLOGIT_TOL_INT8_CPU["max"] and dl.mean() <= smoke.DLOGIT_TOL_INT8_CPU["mean"]
            else:
                f32, unit = float(np.abs(banded[1] - alone[1]).max() / np.abs(alone[1]).max()), "of max|logit|"
                f32_ok = f32 <= smoke.ROWS17_F32_TOL.get(args.model, smoke.ROWS_F32_TOL)
            ok = d.max() <= lim["max"] and d.mean() <= lim["mean"] and f32_ok and banded[4] == alone[4]
            rec = {"model": args.model, "spatial": spatial, "data": n // spatial, "rank": mesh.rank,
                   "images": images, "band_rows": side // spatial,
                   "dlogit_max": float(d.max()), "dlogit_mean": float(d.mean()), "f32_rel": f32, "f32_unit": unit,
                   "ms": banded[2], "ms_alone": alone[2], "peak_gib": banded[3], "peak_gib_alone": alone[3],
                   "launches": banded[4], "ok": bool(ok)}
            recs = [None] * n
            dist.all_gather_object(recs, rec)
            out["serving"] += recs
            if mesh.is_primary:
                for r in recs:
                    print(f"serving {args.model}, {images} x {side}x{side}, data {r['data']} x spatial {r['spatial']}, "
                          f"rank {r['rank']}: "
                          f"|dlogit| / std max {r['dlogit_max']:.3e} mean {r['dlogit_mean']:.3e}; f32 "
                          f"{r['f32_rel']:.3e} {r['f32_unit']}; {r['ms']:.1f} ms banded against {r['ms_alone']:.1f} "
                          f"alone; peak {r['peak_gib']:.3f} against {r['peak_gib_alone']:.3f} GiB; launches "
                          f"{r['launches']}; {'ok' if r['ok'] else 'FAIL'} ({card})", flush=True)
            bad += [f"serving spatial {r['spatial']} rank {r['rank']}" for r in recs if not r["ok"]]
        if args.model not in TRAINED:
            return
        # training: the grid n / 2 x 2 against one process, each rank's reference on its own card
        spatial_subgroups(mesh, 2)
        batch = 2 * n
        train_side = smoke.IMG if source == "flagship" else side
        data = list(samples(n=TRAIN_STEPS * batch, size=train_side, seed=args.seed))
        with tempfile.TemporaryDirectory() as tmp:
            one = smoke.seeded_trainer(cfg, batch, data, False, dev, os.path.join(tmp, "one"), args.seed)
            one.train_epoch(0)
            grid = smoke.seeded_trainer(cfg, batch, data, False, dev, os.path.join(tmp, f"r{mesh.rank}"),
                                        args.seed, mesh=mesh)
            grid.train_epoch(0)
        loss = [s["loss"] for s in grid.step_log]
        want_loss = [s["loss"] for s in one.step_log]
        state = max(float(((a.double() - b.double()).abs() - (smoke.DP_STATE_TOL["atol"] + smoke.DP_STATE_TOL["rtol"]
                                                               * b.double().abs())).max())
                    for a, b in zip(grid.model.state_dict().values(), one.model.state_dict().values())
                    if b.is_floating_point())
        ok = np.allclose(loss, want_loss, **smoke.DP_LOSS_TOL) and state <= 0
        rec = {"grid": f"{n // 2} x 2", "batch": batch, "rank": mesh.rank, "losses": loss, "losses_alone": want_loss,
               "ms": float(np.median([s["ms"] for s in grid.step_log[1:]])),
               "ms_alone": float(np.median([s["ms"] for s in one.step_log[1:]])), "state_excess": state, "ok": bool(ok)}
        recs = [None] * n
        dist.all_gather_object(recs, rec)
        out["training"] = recs
        if mesh.is_primary:
            for r in recs:
                print(f"training {args.model} f32 {train_side}x{train_side}, grid {r['grid']}, global batch {r['batch']}, rank "
                      f"{r['rank']}: losses {[round(v, 6) for v in r['losses']]} against one process's "
                      f"{[round(v, 6) for v in r['losses_alone']]}; the state's largest excess over phase 14(b)'s "
                      f"limits {r['state_excess']:.2e}; {r['ms']:.1f} ms/step against {r['ms_alone']:.1f}; "
                      f"{'ok' if r['ok'] else 'FAIL'} ({card})", flush=True)
        bad += [f"training rank {r['rank']}" for r in recs if not r["ok"]]
    finally:
        mesh.close()
    if mesh.is_primary:
        print(json.dumps(out))
    if bad:
        sys.exit("disagreement: " + "; ".join(bad))


if __name__ == "__main__":
    main()
