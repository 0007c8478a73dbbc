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
  packages see the same batches and a resumed run repeats them.

The multi-host ``shard=`` branch of the JAX loader is not ported (ROADMAP.md,
Queue A 11): passing it raises.
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
    Deterministic given (seed, epoch)."""

    def __init__(self, dataset, batch_size: int, shuffle: bool, num_workers: int = 2,
                 drop_last: bool = False, seed: int = 0, prefetch: int = 2, shard=None):
        if shard is not None:
            raise NotImplementedError("BatchLoader(shard=...): multi-host loading is not ported (ROADMAP.md, "
                                      "Queue A 11)")
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

    def _stack(self, arrays) -> torch.Tensor:
        out = torch.from_numpy(np.stack(arrays))
        return out.pin_memory() if self.pin_memory else out

    def __iter__(self) -> Iterator[dict]:
        order = self._index_order()
        n = len(order)
        nb = len(self)
        # one child generator per sample for reproducible augmentation
        seeds = np.random.default_rng((self.seed, self.epoch, 1)).integers(0, 2**63 - 1, size=n)

        def load_one(i):
            return self.dataset.__getitem__(int(order[i]), rng=np.random.default_rng(int(seeds[i])))

        def make_batch(b, pool):
            rows = range(b * self.batch_size, min((b + 1) * self.batch_size, n))
            samples = list(pool.map(load_one, rows))
            return {"image": self._stack([s["image"] for s in samples]),
                    "mask": self._stack([s["mask"] for s in samples]),
                    "filename": [s["filename"] for s in samples]}

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

    def get_train_loader(self, drop_last: bool = False) -> BatchLoader:
        transform = build_transforms(self.img_size, augment=self.use_augmentation)
        dataset = SegmentationDataset(self.train_dir, transform, self.img_size, cache=self.cache)
        return BatchLoader(dataset, self.batch_size, shuffle=True, num_workers=self.num_workers,
                           drop_last=drop_last, seed=self.seed)

    def get_val_loader(self) -> BatchLoader:
        transform = build_transforms(self.img_size, augment=False)
        dataset = SegmentationDataset(self.val_dir, transform, self.img_size, cache=self.cache)
        return BatchLoader(dataset, self.batch_size, shuffle=False, num_workers=self.num_workers,
                           drop_last=False, seed=self.seed)
