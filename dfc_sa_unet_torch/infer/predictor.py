"""Direct and batched sliding-window prediction (counterpart of
dfc_sa_unet_tpu/infer/predictor.py).

All tiles of an image are cut on the host (uint8), stacked, and run in
fixed-size batches; TTA (identity + hflip + vflip) rides the same batches;
the probabilities are count-averaged back onto the image.  The uint8
batch is normalised on the device.  ``predict_sliding_stream`` fills the
batches with tiles of consecutive images.

Under row sharding (a mesh with ``spatial`` S > 1, parallel/mesh.py) every
rank of a spatial group takes the same batch, cuts its band of the rows on
the host before the copy to the card, runs the forward in the band's context
(parallel/rows.py), and the group all-gathers the bands' probabilities
(through the host on Gloo): each rank returns one process's result.  A
height that is not a multiple of 16 S runs whole on every rank, with JAX's
note once.

Under a ``torch.profiler`` session a request's parts are spans (``utils/profiling.py``):
``predictor.request`` around ``predictor.stage_in`` (the copy to the card),
``predictor.forward`` (normalise, model, sigmoid), ``predictor.gather`` (row bands only) and
``predictor.read_back`` (the copy to the host, which waits for the forward).
"""

import queue
import threading
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from dfc_sa_unet_torch.data.normalize import normalize
from dfc_sa_unet_torch.ops import _build
from dfc_sa_unet_torch.parallel import rows
from dfc_sa_unet_torch.utils.device import resolve_device
from dfc_sa_unet_torch.utils.profiling import span


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Run ``it`` in a background thread, ``depth`` items ahead; exceptions
    re-raise at the consumer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    _END, _ERR = object(), object()

    def producer():
        try:
            for item in it:
                if stop.is_set():
                    return
                q.put(item)
            q.put(_END)
        except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
            q.put((_ERR, e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break


def load_image(image_path: str, target_size: Optional[Tuple[int, int]] = None):
    """RGB uint8 (PIL; cv2 for TIFF incl. BGRA).  Returns (array_for_model,
    original) where array_for_model is resized to target_size (W, H) if
    given, or (None, None) when the file cannot be read."""
    image_path = image_path.replace("\\", "/")
    try:
        if image_path.lower().endswith((".tif", ".tiff")):
            import cv2

            arr = cv2.imread(image_path, cv2.IMREAD_UNCHANGED)
            if arr is None:
                raise IOError(f"cv2 could not read {image_path}")
            if arr.ndim == 3 and arr.shape[2] == 4:
                arr = cv2.cvtColor(arr, cv2.COLOR_BGRA2BGR)
            if arr.ndim == 2:
                arr = cv2.cvtColor(arr, cv2.COLOR_GRAY2BGR)
            original = cv2.cvtColor(arr, cv2.COLOR_BGR2RGB)
        else:
            from PIL import Image, ImageFile

            ImageFile.LOAD_TRUNCATED_IMAGES = True
            original = np.array(Image.open(image_path).convert("RGB"))
        img = original
        if target_size:
            from PIL import Image

            img = np.array(Image.fromarray(original).resize(tuple(target_size), Image.Resampling.BILINEAR))
        return img, original
    except Exception as e:  # noqa: BLE001 - skip-and-continue, as the reference
        print(f"Error: could not load image {image_path}: {e}")
        return None, None


def _tile_coords(h, w, tile_size, overlap):
    stride = tile_size - overlap
    coords = []
    for y in range(0, h, stride):
        for x in range(0, w, stride):
            y_end, x_end = min(y + tile_size, h), min(x + tile_size, w)
            coords.append((max(0, y_end - tile_size), max(0, x_end - tile_size)))
    return coords


class Predictor:
    """Batched forward of a model (an nn.Module or any callable, e.g. a
    DFCEngine) that takes normalised NCHW images and returns NCHW logits.
    Runs on ``device`` (default CUDA, raising without it).  A model with an
    ``img_dim`` attribute (ViT-seg, TransUNet) is served at that size only.
    ``exe_cache_dir``: the directory the CUDA kernels are built in and loaded
    from (``ops/_build.py::set_build_dir``).  ``mesh``: a ``parallel.mesh.ProcessMesh``
    whose ``spatial`` above 1 shards every image's rows over the ranks of a
    spatial group (every model of the factory and every serving engine; an
    int8 engine's activation scales must then be the same on every rank of
    the group, which is checked)."""

    def __init__(self, model, compute_dtype=None, device=None, exe_cache_dir=None, mesh=None):
        if exe_cache_dir is not None:
            _build.set_build_dir(exe_cache_dir)
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype or torch.float32
        self.mesh = mesh if mesh is not None and mesh.group is not None and mesh.spatial > 1 else None
        if self.mesh is not None:
            rows.check_model(model)
            if getattr(model, "act_scales", None) is not None:
                rows.check_same_scales(model.act_scales, self.mesh.spatial_group,
                                       self.device if self.mesh.backend == "nccl" else "cpu")
        self.stride = rows.family_stride(model)
        self._warned_spatial = False
        if isinstance(model, torch.nn.Module):
            model = model.to(self.device, memory_format=torch.channels_last).eval()
        self.model = model

    def _band(self, height: int):
        """This rank's band of a batch of ``height`` rows, or None (no row sharding, or a height that
        breaks the band rule: the batch then runs whole, with JAX's note once)."""
        if self.mesh is None:
            return None
        if rows.divides(height, self.mesh.spatial, self.stride):
            return self.mesh.band(height)
        if not self._warned_spatial and self.mesh.is_primary:
            print(f"(spatial={self.mesh.spatial} does not divide H={height} into bands of whole rows of the model's "
                  f"coarsest grid, a multiple of {self.mesh.spatial * self.stride}; sharding batch only)")
        self._warned_spatial = True
        return None

    @staticmethod
    def _gather_bands(probs: torch.Tensor, band) -> torch.Tensor:
        """The whole images' [B,H,W] probabilities from every band's, on every rank of the group
        (on the card under NCCL, through the host on Gloo)."""
        import torch.distributed as dist

        part = probs.contiguous() if band.backend == "nccl" else probs.cpu()
        parts = [torch.empty_like(part) for _ in range(band.count)]
        dist.all_gather(parts, part, group=band.group)
        return torch.cat(parts, 1)

    @torch.inference_mode()
    def _forward_u8(self, images_u8: np.ndarray) -> np.ndarray:
        with span("predictor.request"):
            band = self._band(images_u8.shape[1])
            if band is not None:
                images_u8 = images_u8[:, band.row0:band.row0 + band.rows]
            with span("predictor.stage_in"):
                x = torch.from_numpy(np.ascontiguousarray(images_u8)).to(self.device, non_blocking=True)
            with span("predictor.forward"):
                x = normalize(x, self.compute_dtype).permute(0, 3, 1, 2)  # NCHW, channels_last
                with rows.band_context(band):
                    probs = torch.sigmoid(self.model(x).float())[:, 0]
            if band is not None:
                with span("predictor.gather"):
                    probs = self._gather_bands(probs, band)
            with span("predictor.read_back"):
                return probs.cpu().numpy()

    def predict_probs(self, images_u8: np.ndarray) -> np.ndarray:
        """[B,H,W,3] uint8 -> [B,H,W] probabilities, the batch run as it is.

        The JAX predictor pads batches of 64-127 to 128 and runs batches above
        128 in chunks of 128, a policy measured on a TPU v5e, whose convolutions
        ran at a fraction of their rate at most other batch sizes
        (dfc_sa_unet_tpu/infer/predictor.py:170-177).  On an H100 the forward's
        time grows with the batch, so both branches lose there: bf16 at
        224x224, the flagship's engine forward takes 68.4 ms at B=64 against
        130.5 padded to 128, 146.7 at B=144 against 151.7 as 128 + 16, 194.6 at
        B=192 against 260.7 as 128 + 128 (the module path alike; every padded
        or chunked size of scripts/bench_torch_predictor_batch.py lost by more
        than the spread between its two runs, PERF.md §4).  The per-image
        results are the same function either way.
        """
        return self._forward_u8(np.asarray(images_u8))

    def _check_tile(self, tile_size: int):
        """The transformer families take one input size only (their position
        embeddings are per patch), so sliding tiles must be that size."""
        img_dim = getattr(self.model, "img_dim", None)
        if img_dim is not None and tile_size != img_dim:
            raise ValueError(f"{type(self.model).__name__} takes {img_dim}x{img_dim} inputs only: "
                             f"use tile_size={img_dim}, not {tile_size}")

    def predict_single(self, image_u8: np.ndarray) -> np.ndarray:
        """One image at its own resolution (reference inference.py:93-102)."""
        return self.predict_probs(image_u8[None])[0]

    def predict_sliding(self, image_u8: np.ndarray, tile_size: int = 224, overlap: int = 50,
                        batch_size: int = 128, tta: bool = False) -> np.ndarray:
        """Overlap-averaged sliding-window prediction (reference inference.py:104-153), batched."""
        self._check_tile(tile_size)
        h, w = image_u8.shape[:2]
        if h < tile_size or w < tile_size:
            return self.predict_single(image_u8)
        coords = _tile_coords(h, w, tile_size, overlap)
        tiles = np.stack([image_u8[ys : ys + tile_size, xs : xs + tile_size] for ys, xs in coords])
        variants = [tiles]
        if tta:
            variants += [tiles[:, :, ::-1], tiles[:, ::-1, :]]  # hflip(W), vflip(H)
        stacked = np.concatenate(variants, axis=0)

        n = stacked.shape[0]
        preds = np.empty((n, tile_size, tile_size), np.float32)
        for lo in range(0, n, batch_size):
            hi = min(lo + batch_size, n)
            chunk = stacked[lo:hi]
            if hi - lo < batch_size:
                chunk = np.concatenate(
                    [chunk, np.zeros((batch_size - (hi - lo), *chunk.shape[1:]), chunk.dtype)])
            preds[lo:hi] = self.predict_probs(chunk)[: hi - lo]

        t = len(coords)
        pred = preds[:t]
        if tta:
            pred = (pred + preds[t : 2 * t, :, ::-1] + preds[2 * t :, ::-1, :]) / 3.0
        canvas = np.zeros((h, w), np.float32)
        counts = np.zeros((h, w), np.float32)
        for p, (ys, xs) in zip(pred, coords):
            canvas[ys : ys + tile_size, xs : xs + tile_size] += p
            counts[ys : ys + tile_size, xs : xs + tile_size] += 1.0
        counts[counts == 0] = 1.0
        return canvas / counts

    def predict_sliding_stream(self, images: Iterable, tile_size: int = 224, overlap: int = 50,
                               batch_size: int = 128, tta: bool = False) -> Iterator:
        """Sliding-window prediction over a stream of ``(key, image_u8)``,
        batching tiles across images; yields ``(key, probs)`` in input order.
        The math is per-image ``predict_sliding``'s."""
        self._check_tile(tile_size)
        pending: dict = {}  # key -> [canvas, counts, remaining_tiles]
        order: list = []
        done: dict = {}  # key -> probs, for images smaller than a tile
        buf_meta: list = []  # (key, ys, xs, variant)
        buf_tiles: list = []

        def run_chunk(final: bool):
            while len(buf_tiles) >= batch_size or (final and buf_tiles):
                take = min(batch_size, len(buf_tiles))
                chunk = np.stack(buf_tiles[:take])
                meta = buf_meta[:take]
                del buf_tiles[:take], buf_meta[:take]
                if take < batch_size:
                    chunk = np.concatenate(
                        [chunk, np.zeros((batch_size - take, *chunk.shape[1:]), chunk.dtype)])
                probs = self.predict_probs(chunk)[:take]
                for (key, ys, xs, var), p in zip(meta, probs):
                    if var == 1:
                        p = p[:, ::-1]
                    elif var == 2:
                        p = p[::-1, :]
                    canvas, counts, _ = pending[key]
                    canvas[ys : ys + tile_size, xs : xs + tile_size] += p
                    counts[ys : ys + tile_size, xs : xs + tile_size] += 1.0
                    pending[key][2] -= 1

        def completed():
            while order:
                key = order[0]
                if key in done:
                    yield key, done.pop(key)
                elif key in pending and pending[key][2] == 0:
                    canvas, counts, _ = pending.pop(key)
                    counts[counts == 0] = 1.0
                    yield key, canvas / counts
                else:
                    return
                order.pop(0)

        for key, image_u8 in images:
            h, w = image_u8.shape[:2]
            order.append(key)
            if h < tile_size or w < tile_size:
                run_chunk(final=True)  # keep emission order: flush older tiles
                done[key] = self.predict_single(image_u8)
                yield from completed()
                continue
            coords = _tile_coords(h, w, tile_size, overlap)
            nvar = 3 if tta else 1
            pending[key] = [np.zeros((h, w), np.float32), np.zeros((h, w), np.float32), len(coords) * nvar]
            for ys, xs in coords:
                tile = image_u8[ys : ys + tile_size, xs : xs + tile_size]
                buf_meta.append((key, ys, xs, 0))
                buf_tiles.append(tile)
                if tta:
                    buf_meta.append((key, ys, xs, 1))
                    buf_tiles.append(tile[:, ::-1])
                    buf_meta.append((key, ys, xs, 2))
                    buf_tiles.append(tile[::-1, :])
            run_chunk(final=False)
            yield from completed()

        run_chunk(final=True)
        yield from completed()
        if pending or done:
            raise RuntimeError(f"unfinished images: {list(pending) + list(done)}")
