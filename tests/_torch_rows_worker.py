"""One process of the CPU row-sharding groups of tests/test_torch_rows_*.py (Gloo, torch only:
this module never imports JAX).

Run as a script, it joins a 2-D mesh of ``--world`` processes, ``--spatial`` ranks a spatial group
(``parallel.mesh.serving_mesh``), runs the named serving cases with each rank on its band of every
image's rows, and saves what each case gives into ``--out`` as ``{case}.rank{rank}.npz``.
Imported, :func:`run_case` with ``mesh=None`` runs the same case in one process, the reference the
tests hold the group to.  :func:`spawn` starts the group, with a hard time limit, from a test.
Training cases run through ``_torch_dp_worker`` (its ``--spatial``).
"""

import argparse
import os
import sys

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
for path in (ROOT, TESTS):
    if path not in sys.path:
        sys.path.insert(0, path)

import _torch_dp_worker as dp  # noqa: E402

# tests/test_parallel_fast.py:302-305's flagship, its widths doubled (at C = 4 the query and key convs
# have C // 8 = 0 channels, which torch's conv refuses); 32x32 for 2 bands (16 rows a band, 1 at the
# bottleneck, whose pool windows then lie one in each band)
FLAGSHIP = {"name": "DFC-SA-Res-Block", "features": [8, 16, 24, 32], "pool_size": 2}
ZOO = ["DFC-SA-Res-Block", "UNet", "UNet_Baseline", "UNet_BothStandardConv", "UNet_AttentionOnly",
       "UNet_AdditionFusion", "UNet_ConcatFusion", "UNet_EncoderOnlyDFC", "UNet_DecoderOnlyDFC"]
SIDE = 32
IMAGES = 3


def zoo_model(name):
    """The DFC family's model ``name`` at the test's widths (the vanilla UNet has its fixed ones)."""
    if name == "UNet":
        return {"name": "UNet", "bilinear": False}
    return {**FLAGSHIP, "name": name}


def images(side=SIDE, n=IMAGES, seed=9):
    return np.random.default_rng(seed).integers(0, 256, (n, side, side, 3), dtype=np.uint8)


def normalised(u8):
    """NHWC f32 images as the Predictor normalises them."""
    import torch

    from dfc_sa_unet_torch.data.normalize import normalize

    return normalize(torch.from_numpy(u8), torch.float32).numpy()


def _seeded(model_cfg, seed=0):
    """The model with seeded weights, BatchNorm statistics jittered so that the folding counts."""
    import torch

    net = dp.build_model(model_cfg, seed)
    with torch.no_grad():
        for name, buf in net.named_buffers():
            if name.endswith("running_mean"):
                buf.add_(0.1 * torch.linspace(-1, 1, buf.numel()))
            elif name.endswith("running_var"):
                buf.mul_(1.0 + 0.2 * torch.linspace(0, 1, buf.numel()))
        for name, p in net.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.5)
    return net.eval()


def run_case(name, mesh, side=SIDE):
    """The case's probabilities through the Predictor with ``mesh`` (or in one process when it is
    None).  Cases: "module" (the flagship, f32), "engine" (its f32 DFCEngine, tail and conv kernels'
    levels "auto"), "zoo" (each of the DFC family's nine models), "fallback" (the flagship at a
    height that breaks the band rule), "logits" (the flagship's logits, without the Predictor).
    Returns numpy arrays, and the printed lines' count of the fallback note."""
    import contextlib
    import io

    import torch

    from dfc_sa_unet_torch.infer.engine import DFCEngine
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.parallel import rows

    out = {}
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        if name in ("module", "engine", "fallback"):
            net = _seeded(FLAGSHIP)
            model = net if name != "engine" else DFCEngine({"model": FLAGSHIP}, net, dtype=torch.float32,
                                                          device="cpu", tail_kernel_levels="auto",
                                                          conv_kernel_levels="auto")
            pred = Predictor(model, device="cpu", mesh=mesh)
            out["probs"] = pred.predict_probs(images(side + 16 if name == "fallback" else side))
            if name == "fallback":
                out["again"] = pred.predict_probs(images(side + 16, seed=10))
        elif name == "logits":  # the flagship's logits of the band, gathered: held against JAX's
            net = _seeded(FLAGSHIP)
            x = torch.from_numpy(normalised(images())).permute(0, 3, 1, 2)
            band = None if mesh is None else mesh.band(side)
            if band is not None:
                x = x[:, :, band.row0:band.row0 + band.rows]
            with torch.no_grad(), rows.band_context(band):
                logits = net(x.contiguous(memory_format=torch.channels_last))[:, 0]
            out["logits"] = (logits if band is None else Predictor._gather_bands(logits, band)).numpy()
        elif name == "zoo":
            for model_name in ZOO:
                pred = Predictor(_seeded(zoo_model(model_name)), device="cpu", mesh=mesh)
                out[model_name] = pred.predict_probs(images(side, 2))
        else:
            raise ValueError(name)
    print(printed.getvalue(), end="")
    out["notes"] = np.array(printed.getvalue().count("sharding batch only"))
    return out


# what row sharding does not reach yet (ROADMAP.md, Queue A 4.2): Trainers and Predictors of these
# models under a 2-band mesh raise
UNPORTED = {"VisionTransformerSegmentation": dp.VIT,
            "UNet_FullResAttention": {**FLAGSHIP, "name": "UNet_FullResAttention"},
            "UNet bilinear": {"name": "UNet", "bilinear": True}}


def mesh_fields(mesh, log_dir):
    """What a test reads of this process's place in the 2-D mesh, whether a Trainer of the flagship
    with ``training.spatial_parallel: 2`` constructs over it, and the messages the unported models'
    Trainers and Predictors raise."""
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.train.trainer import Trainer

    cfg = dp.config(log_dir, FLAGSHIP, *dp.BCE_DICE, 4, SIDE, {"spatial_parallel": 2})
    trainer = Trainer(dp.build_model(FLAGSHIP), None, None, cfg, mesh=mesh, device="cpu", progress=False)
    out = {"fields": np.array([mesh.world_size, mesh.rank, mesh.spatial, mesh.data_size, mesh.data_index,
                               mesh.spatial_index, mesh.spatial_group is not None, mesh.data_group is not None,
                               trainer.spatial, trainer.data_axis])}
    for label, model in UNPORTED.items():
        for kind in ("Trainer", "Predictor"):
            try:
                if kind == "Trainer":
                    Trainer(dp.build_model(model), None, None, cfg, mesh=mesh, device="cpu", progress=False)
                else:
                    Predictor(dp.build_model(model), device="cpu", mesh=mesh)
                out[f"{label} {kind}"] = np.array("constructed")
            except NotImplementedError as e:
                out[f"{label} {kind}"] = np.array(str(e))
    return out


def spawn(cases, out_dir, world=2, spatial=2):
    """Run ``cases`` in a 2-D mesh of ``world`` processes of this module; returns {case: [result of
    rank 0, rank 1, ...]}.  Fails the calling test on a non-zero exit or when a process outlives
    the dp worker's PROCESS_TIMEOUT_S (it is killed)."""
    import subprocess

    from dfc_sa_unet_torch.parallel.mesh import local_coordinator

    coordinator = local_coordinator()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([ROOT, TESTS, os.environ.get("PYTHONPATH", "")]),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world", str(world),
                               "--spatial", str(spatial), "--coordinator", coordinator, "--out", str(out_dir),
                               "--cases", ",".join(cases)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=dp.PROCESS_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{log[-4000:]}"
    return {c: [dict(np.load(os.path.join(out_dir, f"{c}.rank{r}.npz"))) for r in range(world)] for c in cases}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--spatial", type=int, required=True)
    ap.add_argument("--coordinator", required=True, help="rank 0's host:port")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    args = ap.parse_args()

    import faulthandler

    import torch

    faulthandler.enable()
    from dfc_sa_unet_torch.parallel.mesh import serving_mesh

    torch.set_num_threads(1)
    mesh = serving_mesh(args.spatial, device="cpu", coordinator=args.coordinator, num_processes=args.world,
                        process_id=args.rank, timeout_s=dp.INIT_TIMEOUT_S)
    try:
        for case in args.cases.split(","):
            res = mesh_fields(mesh, os.path.join(args.out, f"logs_{args.rank}")) if case == "mesh" \
                else run_case(case, mesh)
            np.savez(os.path.join(args.out, f"{case}.rank{args.rank}.npz"), **res)
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
