"""Serving, one client in a closed loop: each request is ``batch`` uint8 tiles on the host, sent to
``Predictor.predict_probs`` as soon as the previous one returned its probabilities to the host.

Traffic (``traffic`` of the cell): ``batch`` tiles of ``height`` x ``width`` a request, drawn from a
pool of ``pool_requests`` distinct requests of seeded ellipse images (``traffic.ellipses``), in an
order drawn from the seed; ``warmup_requests`` before the window, ``traced_requests`` in the traced
segment.  The program (``program`` of the cell): ``path`` "engine" (``infer/engine.py::DFCEngine``
with the tail and conv3x3 kernels at their "auto" levels, as the inference CLI's ``--engine``) or
"module" (the factory's module), in ``dtype``.

The check: after the window, ``sampled_requests`` of the requests it served, drawn from the seed by
reservoir sampling, are run through the configuration's plain reference in float32 (in blocks of
``reference_block`` images) from the same seeded state dict and the same uint8 tiles, once as it
is and once with its products' operands rounded to bfloat16, and the outputs compared over all the
sampled tiles and tile by tile (``_gaps``).
"""

import time

import numpy as np
import torch

from portbench.core import dtype, host_copy
from portbench.reference.plain import exact_f32, normalize
from portbench.traffic import ellipses
from portbench.trace import UNIT_SPAN
from portbench.weights import seeded_state


def _model(run, sd):
    """The program the cell serves, from the seeded state dict ``sd``."""
    prog = run.workload["program"]
    compute = dtype(prog["dtype"])
    config = {"model": run.config["model"], "dataset": run.config["dataset"]}
    if prog["path"] == "engine":
        from dfc_sa_unet_torch.infer.engine import DFCEngine

        return DFCEngine(config, sd, dtype=compute, device=run.device, tail_kernel_levels="auto",
                         conv_kernel_levels="auto")
    from dfc_sa_unet_torch.models.factory import create_model

    model = create_model(config, dtype=None if compute == torch.float32 else compute, device=run.device)
    missing, unexpected = model.load_state_dict(sd, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked") for k in missing):
        raise KeyError(f"state dict does not fit the module: missing {missing}, unexpected {unexpected}")
    return model


def setup(run):
    from dfc_sa_unet_torch.infer.predictor import Predictor

    t = run.workload["traffic"]
    b, p = t["batch"], t["pool_requests"]
    with run.part("weights"):
        sd = seeded_state(run.reference.state_spec(run.config), run.seed, run.device)
    with run.part("program"):
        predictor = Predictor(_model(run, sd), compute_dtype=dtype(run.workload["program"]["dtype"]),
                              device=run.device)
    sd_host = {k: host_copy(v) for k, v in sd.items()}
    del sd
    with run.part("traffic"):
        images, _ = ellipses(b * p, t["height"], t["width"], run.seed, run.device)
        pool = images.cpu().numpy().reshape(p, b, t["height"], t["width"], 3)
        del images
    rng = np.random.default_rng([run.seed, 1])
    with run.part("warmup"):
        for i in range(t["warmup_requests"]):
            predictor.predict_probs(pool[i % p])
    return {"predictor": predictor, "pool": pool, "sd": sd_host,
            "order": rng.integers(0, p, size=1 << 20), "sample_rng": np.random.default_rng([run.seed, 2])}


def window(run, st):
    """Requests back to back until ``run.seconds`` have passed; every request's latency counts.  A
    uniform sample of the served requests, drawn from the seed by reservoir sampling, is copied into
    buffers made in set-up, so that every request's answer is dropped alike."""
    serve, pool, order = st["predictor"].predict_probs, st["pool"], st["order"]
    t = run.workload["traffic"]
    k = t["sampled_requests"]
    rng = st["sample_rng"]
    buffers = np.empty((k, t["batch"], t["height"], t["width"]), np.float32)
    sampled = [None] * k  # the pool request each buffer holds the answer to
    lat = []
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < run.seconds:
        j = len(lat)
        t0 = time.perf_counter()
        probs = serve(pool[order[j]])
        t_end = time.perf_counter()
        lat.append(t_end - t0)
        slot = j if j < k else int(rng.integers(0, j + 1))
        if slot < k:
            np.copyto(buffers[slot], probs)
            sampled[slot] = int(order[j])
        del probs
    wall = t_end - t_start
    n = len(lat)
    run.attempted, run.failed = n, 0
    images = n * t["batch"]
    run.window = {"seconds": wall, "units": n, "images": images}
    st["sample"] = [(i, buffers[s]) for s, i in enumerate(sampled) if i is not None]
    return {"serve_img_per_s": images / wall, "serve_p95_ms": float(np.percentile(np.array(lat), 95)) * 1e3}


def traced(run, st):
    serve, pool, order = st["predictor"].predict_probs, st["pool"], st["order"]
    for j in range(run.workload["traffic"]["traced_requests"]):
        with torch.profiler.record_function(UNIT_SPAN):
            serve(pool[order[j]])


def release(run, st):
    kept = {"sd": st["sd"], "sample": st["sample"], "pool": st["pool"]}
    st.clear()
    return kept


def _reference_probs(run, sd, x_u8, precision=None):
    """The reference's probabilities of the uint8 tiles ``x_u8``, its products' operands rounded
    to ``precision`` (None: float32)."""
    block = run.workload["traffic"]["reference_block"]
    model = run.reference.Model(run.config, sd, precision=precision)
    out = []
    with torch.no_grad():
        for i in range(0, x_u8.shape[0], block):
            x = torch.from_numpy(np.ascontiguousarray(x_u8[i:i + block])).to(run.device)
            out.append(torch.sigmoid(model(normalize(x)))[:, 0].cpu())
    return torch.cat(out).numpy()


def _logit(p):
    p = np.clip(p.astype(np.float64), 1e-7, 1.0 - 1e-7)
    return np.log(p) - np.log1p(-p)


TAIL = 0.3  # a logit departure, in units of the reference logits' spread, whose share of pixels is read


def _gaps(got, want, rounded):
    """Readings of the probabilities ``got`` against the float32 reference's ``want`` [images, H,
    W], in the logits (from the probabilities) in units of the reference logits' spread, which
    takes out how far a seed's weights scale the output: the largest and the mean gap, the share of
    pixels that depart by more than ``TAIL``, and per image the largest mean gap and share.  And
    against ``rounded``, the reference with its products' operands rounded to bfloat16, the
    precision the cells state: its own mean gap, and the largest over the images of the program's
    mean gap on an image over the rounded reference's on the same image, which reads how far the
    program departs on each image in units of what bfloat16 rounding does to that image."""
    z = _logit(want)
    spread = z.std()
    dz = (np.abs(_logit(got) - z) / spread).reshape(z.shape[0], -1)
    dr = (np.abs(_logit(rounded) - z) / spread).reshape(z.shape[0], -1)
    per_image, rounding = dz.mean(axis=1), dr.mean(axis=1)
    over = per_image / np.maximum(rounding, 0.1 * np.median(rounding))
    worst = int(per_image.argmax())
    return [("logit_gap_max", float(dz.max())), ("logit_gap_mean", float(dz.mean())),
            ("tail_share", float((dz > TAIL).mean())), ("image_gap_max", float(per_image[worst])),
            ("image_tail_max", float((dz > TAIL).mean(axis=1).max())),
            ("bf16_gap_mean", float(dr.mean())), ("bf16_gap_of_worst_image", float(rounding[worst])),
            ("image_gap_over_bf16_max", float(over.max()))]


def check(run, kept):
    """The program's probabilities of the sampled requests against the float32 reference's (and
    the bfloat16-rounded reference's)."""
    with exact_f32():
        sd = {k: v.to(run.device) for k, v in kept["sd"].items()}
        pool = kept["pool"]
        got = np.concatenate([p for _, p in kept["sample"]])
        x = np.concatenate([pool[i] for i, _ in kept["sample"]])
        return _gaps(got, _reference_probs(run, sd, x), _reference_probs(run, sd, x, "bf16"))
