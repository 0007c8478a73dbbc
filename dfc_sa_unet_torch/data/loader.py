"""Batched, prefetching host input pipeline (counterpart of
dfc_sa_unet_tpu/data/loader.py).

* worker threads decode and augment in uint8 (PIL releases the GIL for
  decode and resize); batches are stacked NHWC uint8 on the host, in
  pinned memory where CUDA is present;
* ``to_device`` ships a uint8 batch with ``non_blocking=True``; it is
  normalised on the device (data/normalize.py): a quarter of the
  host-to-device traffic of f32, and the same values as ToTensor + Normalize;
* the next batch is decoded while the current step runs (``prefetch``);
* the order of an epoch and every sample's augmentation seed come from
  ``(seed, epoch)`` alone, with the JAX loader's arithmetic, so both
  packages see the same batches and a resumed run repeats them;
* ``shard=(process_id, process_count)`` loads this process's contiguous
  chunk of every global batch, with the JAX loader's arithmetic
  (dfc_sa_unet_tpu/data/loader.py:47-70, 140-182): every process takes the
  same order, each global batch of g rows is conceptually zero-padded to
  ``process_count`` chunks of ``ceil(g / process_count)`` rows (rounded up
  to ``shard_pad_multiple``), and a chunk that holds padding carries a
  ``valid`` [chunk] f32 mask (``partial="pad"``, for evaluation); with
  ``partial="replicate"`` (training) a batch that does not divide is
  loaded whole on every process and carries ``replicated: True``.  A
  sharded batch lists the global batch's names in ``filename_global``;
  ``filename`` lists this chunk's real rows;
* ``microbatches=k`` (training under ``grad_accum`` k, ``partial=
  "replicate"``) shards each of the k microbatches of a global batch
  instead of the batch: of mb = g / k rows each, process r loads rows
  [m mb + r mb / P, m mb + (r + 1) mb / P) for m = 0 .. k-1 in turn, so
  that chunking its rows in k gives its share of every microbatch (JAX's
  microbatch m under a mesh is the single-device one split across the
  devices, dfc_sa_unet_tpu/train/trainer.py:318-381).  A batch whose
  microbatch does not divide among the processes is loaded whole with
  ``replicated: True``; one that k does not divide keeps the contiguous
  layout (the trainer runs it as one step).
"""

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator

import numpy as np
import torch

from dfc_sa_unet_torch.data.dataset import SegmentationDataset
from dfc_sa_unet_torch.data.transforms import build_transforms


def binarize_mask(masks_u8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8 [B,H,W] -> {0,1} [B,1,H,W] ((v/255) > 0.5 <=> v >= 128,
    reference utils/data_loader.py:55-62)."""
    return (masks_u8 >= 128).to(dtype).unsqueeze(1)


def to_device(batch: dict, device) -> tuple:
    """The batch's uint8 image [B,H,W,3] and mask [B,H,W] on ``device``."""
    return (batch["image"].to(device, non_blocking=True), batch["mask"].to(device, non_blocking=True))


class BatchLoader:
    """Iterable over dict batches {'image' u8 [B,H,W,3], 'mask' u8 [B,H,W],
    'filename' list}; the arrays are torch tensors on the host.
    Deterministic given (seed, epoch).  ``shard``: see the module's docstring."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, num_workers: int = 2,
                 drop_last: bool = False, seed: int = 0, prefetch: int = 2, shard=None,
                 shard_pad_multiple: int = 1, partial: str = "pad", microbatches: int = 1):
        if shard is not None and not 0 <= shard[0] < shard[1]:
            raise ValueError(f"shard id {shard[0]} out of range for {shard[1]} processes")
        if partial not in ("pad", "replicate"):
            raise ValueError(f"partial must be 'pad' or 'replicate', got {partial!r}")
        if microbatches < 1 or (microbatches > 1 and partial != "replicate"):
            raise ValueError(f"microbatches={microbatches} needs a positive count and partial='replicate'")
        self.shard = shard
        self.microbatches = int(microbatches)
        self.shard_pad_multiple = max(1, int(shard_pad_multiple))
        self.partial = partial
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.pin_memory = torch.cuda.is_available()
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _index_order(self):
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng((self.seed, self.epoch)).permutation(n)
        return np.arange(n)

    def _stack(self, array: np.ndarray) -> torch.Tensor:
        out = torch.from_numpy(array)
        return out.pin_memory() if self.pin_memory else out

    def __iter__(self) -> Iterator[dict]:
        order = self._index_order()
        n = len(order)
        nb = len(self)
        # one child generator per sample for reproducible augmentation
        seeds = np.random.default_rng((self.seed, self.epoch, 1)).integers(0, 2**63 - 1, size=n)

        def load_one(i):
            return self.dataset.__getitem__(int(order[i]), rng=np.random.default_rng(int(seeds[i])))

        def load_rows(rows, pool):
            samples = list(pool.map(load_one, rows))
            return {"image": np.stack([s["image"] for s in samples]),
                    "mask": np.stack([s["mask"] for s in samples]),
                    "filename": [s["filename"] for s in samples]}

        def make_batch(b, pool):
            lo, hi = b * self.batch_size, min((b + 1) * self.batch_size, n)
            batch = load_rows(range(lo, hi), pool) if self.shard is None else shard_rows(lo, hi, pool)
            batch["image"], batch["mask"] = self._stack(batch["image"]), self._stack(batch["mask"])
            return batch

        def shard_rows(lo, hi, pool):
            pid, nproc = self.shard
            g = hi - lo
            m = self.shard_pad_multiple
            per_proc = -(-g // nproc)  # ceil(g / nproc)
            chunk = -(-per_proc // m) * m  # rounded up to the multiple
            names_global = [self.dataset.samples[int(order[i])][2] for i in range(lo, hi)]
            uneven = chunk * nproc != g
            k = self.microbatches
            if k > 1 and g % k == 0:
                mb = g // k
                per = mb // nproc
                if mb % nproc == 0 and per % m == 0:  # this process's share of each microbatch in turn
                    batch = load_rows([lo + j * mb + pid * per + i for j in range(k) for i in range(per)], pool)
                    batch["filename_global"] = names_global
                    return batch
                uneven = True  # a microbatch does not divide among the processes
            if uneven and self.partial == "replicate":
                batch = load_rows(range(lo, hi), pool)
                batch.update(replicated=True, filename_global=names_global)
                return batch
            start = lo + pid * chunk
            if start < hi:
                batch = load_rows(range(start, min(start + chunk, hi)), pool)
            else:  # this process holds padding only: one sample for the shapes, then no rows of it
                probe = load_rows(range(lo, lo + 1), pool)
                batch = {"image": probe["image"][:0], "mask": probe["mask"][:0], "filename": []}
            pad = chunk - batch["image"].shape[0]
            if pad:
                for key in ("image", "mask"):
                    batch[key] = np.concatenate([batch[key], np.zeros((pad, *batch[key].shape[1:]), batch[key].dtype)])
            if chunk * nproc != g:
                batch["valid"] = np.concatenate([np.ones(chunk - pad, np.float32), np.zeros(pad, np.float32)])
            batch["filename_global"] = names_global
            return batch

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        q.put(make_batch(b, pool))
            except BaseException as e:  # hand a worker's failure to the consumer
                q.put(e)
            finally:
                q.put(None)

        threading.Thread(target=producer, daemon=True).start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            while not q.empty():  # drain so the producer can exit
                try:
                    q.get_nowait()
                except queue.Empty:
                    break


class DataLoaderFactory:
    """Loaders from a config (reference utils/data_loader.py:75-185).

    ``img_size`` goes straight to PIL.resize, which takes (W, H), as in the
    reference; all shipped configs are square."""

    def __init__(self, config, seed: int = 0):
        self.config = config
        ds = config["dataset"]
        tr = config["training"]
        self.train_dir = ds["train_dir"].replace("\\", "/")
        self.val_dir = ds["val_dir"].replace("\\", "/")
        self.batch_size = tr["batch_size"]
        self.num_workers = tr.get("num_workers", 2)
        img = ds.get("img_size", [224, 224])
        self.img_size = (img, img) if isinstance(img, int) else tuple(img)
        self.use_augmentation = ds.get("augmentation", True)
        # "auto": decode and resize once into RAM when the set fits a quarter of the free memory
        self.cache = ds.get("cache", "auto")
        self.seed = seed

    def get_train_loader(self, drop_last: bool = False, shard=None, shard_pad_multiple: int = 1,
                         microbatches: int = 1) -> BatchLoader:
        """``partial='replicate'``: a padded train batch would change the BatchNorm statistics;
        ``microbatches``: the trainer's ``grad_accum``, which decides each process's rows."""
        transform = build_transforms(self.img_size, augment=self.use_augmentation)
        dataset = SegmentationDataset(self.train_dir, transform, self.img_size, cache=self.cache)
        return BatchLoader(dataset, self.batch_size, shuffle=True, num_workers=self.num_workers,
                           drop_last=drop_last, seed=self.seed, shard=shard, shard_pad_multiple=shard_pad_multiple,
                           partial="replicate", microbatches=microbatches)

    def get_val_loader(self, shard=None, shard_pad_multiple: int = 1) -> BatchLoader:
        """``partial='pad'``: the trainer's eval step masks the padding."""
        transform = build_transforms(self.img_size, augment=False)
        dataset = SegmentationDataset(self.val_dir, transform, self.img_size, cache=self.cache)
        return BatchLoader(dataset, self.batch_size, shuffle=False, num_workers=self.num_workers,
                           drop_last=False, seed=self.seed, shard=shard, shard_pad_multiple=shard_pad_multiple,
                           partial="pad")
