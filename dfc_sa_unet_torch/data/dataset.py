"""SegmentationDataset (a copy of dfc_sa_unet_torch/data/dataset.py; PIL is
imported at use) - the dataset the reference *imports but does not
ship* (``from datasets.segmentation_dataset import SegmentationDataset``
at reference utils/data_loader.py:7; no ``datasets/`` directory exists).

Re-specified from its call contract:
  * ctor ``(root, transform, img_size)`` (reference utils/data_loader.py:147-151)
  * scans ``root/original/`` and ``root/mask/`` for identically-named
    files (reference README.md:67-76)
  * ``__getitem__`` returns ``{'image', 'mask', 'filename'}``
    (consumed at reference utils/trainer.py:116-117,195-197)
  * applies the paired transform ``t(img, mask)``

Images load as RGB, masks as grayscale ('L').  Mask files may use a
different extension than their image (matched by basename).

``cache=True`` decodes and resizes each pair once (lazily, thread-safe by
idempotence) and keeps the post-resize uint8 arrays in RAM (~200 KB per
224x224 sample); later epochs replay them through the same transform
pipeline, so random augmentation still varies per epoch while the PNG
decode + downscale - the dominant host cost on a 1-core host - is paid
once.  Parity-exact: the deterministic PairedResize precedes every random
transform, and resizing an already-resized image is the identity.

``cache="auto"`` (the ``dataset.cache`` config default) enables the cache
only when the whole decoded dataset fits in a quarter of the host's
currently-available RAM - uncached, the host pipeline feeds ~144 img/s on
a one-core host (measured for the JAX package), so caching whenever it is
safe is the right default.

``cache="disk"`` extends the same decode-once win to datasets too large
for RAM (e.g. the Mapping Challenge satellite set the reference targets):
the post-resize uint8 arrays are written once to ``.npy`` memmaps next to
the dataset (``<root>/.dfc_cache/``, falling back to
``~/.cache/dfc_sa_unet_torch/`` when the dataset directory is read-only) and
replayed by memory-mapped reads.  The manifest records every source
file's (path, mtime, size); any mismatch rebuilds the cache.  Explicit
opt-in only - ``auto`` never writes to disk.

Contract safety: post-resize arrays are cached only when the transform
provably begins with ``PairedResize(img_size)`` (every shipped pipeline —
``build_transforms`` - does).  Any other transform (including ``None``)
caches the decoded ORIGINALS under ``cache=True`` so cached and uncached
modes return identical data, and ``"auto"`` disables itself (the
original-resolution footprint is unknown before decoding).
"""

import hashlib
import json
import os
from typing import Callable, Optional, Tuple, Union

import numpy as np


def _pil():
    """PIL.Image, tolerating truncated files like reference inference.py:18-19."""
    from PIL import Image, ImageFile

    ImageFile.LOAD_TRUNCATED_IMAGES = True
    return Image

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")

# auto mode caches only if the decoded set fits in this fraction of
# MemAvailable (tests monkeypatch _mem_available_bytes)
_AUTO_CACHE_RAM_FRACTION = 0.25
_AUTO_CACHE_FALLBACK_BUDGET = 512 * 1024**2  # MemAvailable unreadable


def _mem_available_bytes() -> Optional[int]:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


class SegmentationDataset:
    def __init__(
        self,
        root: str,
        transform: Optional[Callable] = None,
        img_size: Tuple[int, int] = (224, 224),
        cache: Union[bool, str] = False,
    ):
        self.root = root.replace("\\", "/")
        self.transform = transform
        self.img_size = tuple(img_size)
        img_dir = os.path.join(self.root, "original")
        mask_dir = os.path.join(self.root, "mask")
        if not os.path.isdir(img_dir) or not os.path.isdir(mask_dir):
            raise FileNotFoundError(
                f"expected '{img_dir}' and '{mask_dir}' directories (README dataset layout)"
            )
        masks_by_base = {}
        for f in sorted(os.listdir(mask_dir)):
            base, ext = os.path.splitext(f)
            if ext.lower() in _IMG_EXTS:
                masks_by_base.setdefault(base, os.path.join(mask_dir, f))
        self.samples = []
        for f in sorted(os.listdir(img_dir)):
            base, ext = os.path.splitext(f)
            if ext.lower() in _IMG_EXTS and base in masks_by_base:
                self.samples.append((os.path.join(img_dir, f), masks_by_base[base], f))
        if not self.samples:
            raise FileNotFoundError(f"no paired image/mask files under {self.root}")
        # Caching post-RESIZE arrays is only contract-exact when the
        # transform provably begins with the matching deterministic
        # resize (all shipped pipelines do - build_transforms).  For any
        # other transform (incl. None) the cache stores the decoded
        # ORIGINALS instead, so cached and uncached modes return
        # identical data; 'auto' then disables (original-resolution
        # footprint is unknown before decoding).
        self._cache_resized = self._transform_starts_with_resize()
        self._disk = None
        if cache == "disk":
            if not self._cache_resized:
                raise ValueError(
                    "cache='disk' stores post-resize arrays, which requires the "
                    "transform to begin with PairedResize(img_size); pass the "
                    "build_transforms pipeline or use cache=True/False"
                )
            self._disk = self._open_disk_cache()
            self.cache = True
            self._cached = None  # memmap-backed, no per-index dict
            return
        if isinstance(cache, str) and cache != "auto":
            raise ValueError(f"cache must be True/False/'auto'/'disk', got {cache!r}")
        if cache == "auto":
            if not self._cache_resized:
                cache = False
            else:
                # post-resize uint8 footprint: H*W*3 image + H*W mask per pair
                need = len(self.samples) * (self.img_size[0] * self.img_size[1] * 4)
                avail = _mem_available_bytes()
                budget = (_AUTO_CACHE_FALLBACK_BUDGET if avail is None
                          else int(avail * _AUTO_CACHE_RAM_FRACTION))
                cache = need <= budget
                if not cache:
                    print(f"dataset cache auto-disabled: {need / 1e6:.0f} MB decoded"
                          f" > {budget / 1e6:.0f} MB budget ({self.root})")
        self.cache = bool(cache)
        self._cached = {} if self.cache else None

    def _decode_resized(self, img_path, mask_path):
        """Decode + deterministic resize - the ONE place the parity contract
        (image BILINEAR, mask NEAREST, PIL (W,H) pass-through like the
        reference's ExtResize) lives for both the RAM and disk caches."""
        Image = _pil()
        img = Image.open(img_path).convert("RGB").resize(self.img_size, Image.BILINEAR)
        mask = Image.open(mask_path).convert("L").resize(self.img_size, Image.NEAREST)
        return img, mask

    def _disk_cache_dir(self) -> str:
        """Prefer <root>/.dfc_cache; fall back to ~/.cache when unwritable."""
        local = os.path.join(self.root, ".dfc_cache")
        try:
            os.makedirs(local, exist_ok=True)
            probe = os.path.join(local, ".w")
            with open(probe, "w"):
                pass
            os.remove(probe)
            return local
        except OSError:
            key = hashlib.sha256(os.path.abspath(self.root).encode()).hexdigest()[:16]
            alt = os.path.join(os.path.expanduser("~"), ".cache", "dfc_sa_unet_torch", key)
            os.makedirs(alt, exist_ok=True)
            return alt

    def _open_disk_cache(self):
        """Open (building/rebuilding as needed) the post-resize memmap cache.

        Returns (imgs_mm [N,H,W,3] u8, masks_mm [N,H,W] u8) opened
        read-only.  Staleness is keyed on every source file's
        (path, mtime_ns, size) plus img_size - any change rebuilds.
        """
        w, h = self.img_size[0], self.img_size[1]  # PIL resize takes (W, H)
        cdir = self._disk_cache_dir()
        tag = f"{w}x{h}"
        paths = {k: os.path.join(cdir, f"{k}_{tag}.npy") for k in ("imgs", "masks")}
        man_path = os.path.join(cdir, f"manifest_{tag}.json")

        def stat_row(p):
            st = os.stat(p)
            # key on root-relative paths so a different cwd / spelling of
            # the same root does not spuriously rebuild a multi-GB cache
            return [os.path.relpath(p, self.root), st.st_mtime_ns, st.st_size]

        manifest = {
            "img_size": [w, h],
            "samples": [stat_row(ip) + stat_row(mp) for ip, mp, _ in self.samples],
        }
        try:
            with open(man_path) as f:
                fresh = (json.load(f) == manifest
                         and all(os.path.exists(p) for p in paths.values()))
        except (OSError, ValueError):
            fresh = False
        if not fresh:
            n = len(self.samples)
            print(f"building disk cache for {n} samples under {cdir} ...", flush=True)
            # per-process tmp names: concurrent writers (train + eval jobs
            # starting together) each publish atomically via os.replace and
            # never write into each other's files
            tmp = f".tmp{os.getpid()}"
            imgs = np.lib.format.open_memmap(
                paths["imgs"] + tmp, mode="w+", dtype=np.uint8, shape=(n, h, w, 3))
            masks = np.lib.format.open_memmap(
                paths["masks"] + tmp, mode="w+", dtype=np.uint8, shape=(n, h, w))
            for i, (ip, mp, _) in enumerate(self.samples):
                img, mask = self._decode_resized(ip, mp)
                imgs[i] = np.asarray(img, np.uint8)
                masks[i] = np.asarray(mask, np.uint8)
            imgs.flush()
            masks.flush()
            del imgs, masks
            for k in paths:
                os.replace(paths[k] + tmp, paths[k])
            with open(man_path + tmp, "w") as f:
                json.dump(manifest, f)
            os.replace(man_path + tmp, man_path)
        return (np.load(paths["imgs"], mmap_mode="r"),
                np.load(paths["masks"], mmap_mode="r"))

    def _transform_starts_with_resize(self) -> bool:
        from dfc_sa_unet_torch.data.transforms import PairedCompose, PairedResize

        t = self.transform
        if isinstance(t, PairedCompose) and t.transforms:
            t = t.transforms[0]
        return isinstance(t, PairedResize) and tuple(t.size) == self.img_size

    def __len__(self):
        return len(self.samples)

    def _load_pair(self, idx):
        Image = _pil()
        img_path, mask_path, _ = self.samples[idx]
        if self._disk is not None:
            imgs_mm, masks_mm = self._disk
            return (Image.fromarray(np.ascontiguousarray(imgs_mm[idx]), "RGB"),
                    Image.fromarray(np.ascontiguousarray(masks_mm[idx]), "L"))
        if self._cached is None:
            return Image.open(img_path).convert("RGB"), Image.open(mask_path).convert("L")
        hit = self._cached.get(idx)
        if hit is None:
            if self._cache_resized:
                img, mask = self._decode_resized(img_path, mask_path)
            else:
                img = Image.open(img_path).convert("RGB")
                mask = Image.open(mask_path).convert("L")
            hit = (np.asarray(img, np.uint8), np.asarray(mask, np.uint8))
            self._cached[idx] = hit  # GIL-atomic; duplicate fills are idempotent
        return Image.fromarray(hit[0], "RGB"), Image.fromarray(hit[1], "L")

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        _, _, filename = self.samples[idx]
        img, mask = self._load_pair(idx)
        if self.transform is not None:
            img, mask = self.transform(img, mask, rng=rng)
        return {"image": img, "mask": mask, "filename": filename}


class ArrayDataset:
    """Samples held as uint8 arrays in memory, with SegmentationDataset's
    ``__getitem__`` contract: for data made by the program itself
    (data/synthetic.py::samples) where there are no files and no PIL."""

    def __init__(self, items):
        """``items``: an iterable of (filename, image [H,W,3] u8, mask [H,W] u8)."""
        self.items = [(str(n), np.asarray(i, np.uint8), np.asarray(m, np.uint8)) for n, i, m in items]
        if not self.items:
            raise ValueError("ArrayDataset needs at least one sample")
        self.samples = [(None, None, name) for name, _, _ in self.items]
        self.cache = True

    def __len__(self):
        return len(self.items)

    def __getitem__(self, idx, rng: Optional[np.random.Generator] = None):
        name, img, mask = self.items[idx]
        return {"image": img, "mask": mask, "filename": name}
