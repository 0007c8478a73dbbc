#!/usr/bin/env python3
"""Row (spatial) sharding across cards over NCCL: one process a card, each holding a band of every
image's rows, against one process on the whole image.

    python3 -m torch.distributed.run --standalone --nproc_per_node N scripts/bench_torch_rows.py \\
        [--side 2048] [--reps 3] [--seed 0]

N cards (2 or more, even).  Serving: for S = 2 and, where N allows it, S = N, the processes form a
serving mesh of N / S data groups of S bands (``parallel.mesh.spatial_subgroups``, NCCL: the halos
move on the cards by ``batch_isend_irecv``), and each data group serves one ``--side`` x ``--side``
image of its own through the flagship's bf16 engine ("auto" levels, seeded weights broadcast from
rank 0), the Predictor cutting the band and gathering the probabilities; every rank first serves
its image alone on its card, the one-process reference.  Agreement: the bf16 probabilities at
chip_smoke phase 5's limits (|dlogit| / std max 0.5, mean 0.05), the f32 engine's logits within
1e-5 of max |logit|.  Times: the request's wall time (host clock, median of ``--reps`` after one
warm-up) and peak allocated memory, banded and alone.  Training: the flagship's f32 step at
224x224 over the grid N / 2 x 2 (two bands of 112 rows), global batch 2 N, 3 steps, against one
process (each rank trains the whole batch alone on its card first), losses and state at chip_smoke
phase 14(b)'s limits, ms/step beside one process's.  Prints a line per check and last one JSON
line of every number; exits non-zero on a disagreement.  Needs N CUDA cards.
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
from dfc_sa_unet_torch.infer.predictor import Predictor  # noqa: E402
from dfc_sa_unet_torch.models.factory import create_model  # noqa: E402
from dfc_sa_unet_torch.ops import launches, reset_launches  # noqa: E402
from dfc_sa_unet_torch.parallel import multihost as mh, rows  # noqa: E402
from dfc_sa_unet_torch.parallel.mesh import data_parallel_mesh, spatial_subgroups  # noqa: E402
from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, init_random_  # noqa: E402

TRAIN_STEPS = 3


def serve(weights, image, dev, mesh, reps):
    """(probs, f32 logits, median ms, peak GiB, launches of one bf16 request) of ``image`` through the
    bf16 engine's Predictor (banded over ``mesh`` when it has a spatial axis) and the f32 engine."""
    pred = Predictor(DFCEngine(smoke.CONFIG, weights, dtype=torch.bfloat16, device=dev, tail_kernel_levels="auto",
                               conv_kernel_levels="auto"), compute_dtype=torch.bfloat16, device=dev, mesh=mesh)
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
    del pred
    engine = DFCEngine(smoke.CONFIG, weights, dtype=torch.float32, device=dev, tail_kernel_levels="auto",
                       conv_kernel_levels="auto")
    band = None if mesh is None or mesh.spatial == 1 else mesh.band(image.shape[1])
    part = image if band is None else image[:, band.row0:band.row0 + band.rows]
    x = normalize(torch.from_numpy(np.ascontiguousarray(part)).to(dev), torch.float32).permute(0, 3, 1, 2)
    with torch.inference_mode(), rows.band_context(band):
        logits = engine(x)[:, 0].float()
        if band is not None:
            logits = Predictor._gather_bands(logits, band)
    del engine
    torch.cuda.empty_cache()
    return probs, logits.cpu().numpy(), float(np.median(ms)), peak, counts


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--side", type=int, default=2048)
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
    try:
        model = init_random_(create_model(smoke.CONFIG, device="cpu"), torch.Generator().manual_seed(args.seed)).to(dev)
        calib = np.random.default_rng(args.seed).integers(0, 256, (16, smoke.IMG, smoke.IMG, 3), dtype=np.uint8)
        calibrate_batch_stats_(model, normalize(torch.from_numpy(calib).to(dev)).permute(0, 3, 1, 2))
        weights = mh.broadcast_tree({k: v.detach() for k, v in model.state_dict().items()})  # rank 0's everywhere
        del model
        for spatial in sorted({2, n}):
            spatial_subgroups(mesh, spatial)
            image = np.random.default_rng(args.seed + mesh.data_index).integers(
                0, 256, (1, args.side, args.side, 3), dtype=np.uint8)
            alone = serve(weights, image, dev, None, args.reps)
            banded = serve(weights, image, dev, mesh, args.reps)
            want = smoke.logit_of(alone[0])
            d = np.abs(smoke.logit_of(banded[0]) - want) / want.std()
            f32 = float(np.abs(banded[1] - alone[1]).max() / np.abs(alone[1]).max())
            ok = (d.max() <= smoke.DLOGIT_TOL_BF16["max"] and d.mean() <= smoke.DLOGIT_TOL_BF16["mean"]
                  and f32 <= smoke.ROWS_F32_TOL and banded[4] == alone[4])
            rec = {"spatial": spatial, "data": n // spatial, "rank": mesh.rank, "band_rows": args.side // spatial,
                   "dlogit_max": float(d.max()), "dlogit_mean": float(d.mean()), "f32_rel": f32,
                   "ms": banded[2], "ms_alone": alone[2], "peak_gib": banded[3], "peak_gib_alone": alone[3],
                   "launches": banded[4], "ok": bool(ok)}
            recs = [None] * n
            dist.all_gather_object(recs, rec)
            out["serving"] += recs
            if mesh.is_primary:
                for r in recs:
                    print(f"serving {args.side}x{args.side}, data {r['data']} x spatial {r['spatial']}, rank {r['rank']}: "
                          f"|dlogit| / std max {r['dlogit_max']:.3e} mean {r['dlogit_mean']:.3e}; f32 "
                          f"{r['f32_rel']:.3e} of max|logit|; {r['ms']:.1f} ms banded against {r['ms_alone']:.1f} "
                          f"alone; peak {r['peak_gib']:.3f} against {r['peak_gib_alone']:.3f} GiB; launches "
                          f"{r['launches']}; {'ok' if r['ok'] else 'FAIL'} ({card})", flush=True)
            bad += [f"serving spatial {r['spatial']} rank {r['rank']}" for r in recs if not r["ok"]]
        # training: the grid n / 2 x 2 against one process, each rank's reference on its own card
        spatial_subgroups(mesh, 2)
        batch = 2 * n
        data = list(samples(n=TRAIN_STEPS * batch, size=smoke.IMG, seed=args.seed))
        with tempfile.TemporaryDirectory() as tmp:
            one = smoke.seeded_trainer(smoke.CONFIG, batch, data, False, dev, os.path.join(tmp, "one"), args.seed)
            one.train_epoch(0)
            grid = smoke.seeded_trainer(smoke.CONFIG, batch, data, False, dev, os.path.join(tmp, f"r{mesh.rank}"),
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
               "ms_alone": float(np.median([s["ms"] for s in one.step_log[1:]])), "ok": bool(ok)}
        recs = [None] * n
        dist.all_gather_object(recs, rec)
        out["training"] = recs
        if mesh.is_primary:
            for r in recs:
                print(f"training f32 {smoke.IMG}x{smoke.IMG}, grid {r['grid']}, global batch {r['batch']}, rank "
                      f"{r['rank']}: losses {[round(v, 6) for v in r['losses']]} against one process's "
                      f"{[round(v, 6) for v in r['losses_alone']]}; {r['ms']:.1f} ms/step against {r['ms_alone']:.1f}; "
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
