"""Synthetic segmentation data: random ellipse blobs (counterpart of
dfc_sa_unet_tpu/data/synthetic.py, with the same random stream).

``samples`` yields the arrays of each sample without touching the disk
(numpy only); ``generate`` writes them in the README dataset layout
(``<dir>/original/*.png`` + ``<dir>/mask/*.png``) with PIL, for end-to-end
tests and smoke training without real data.

CLI: ``python -m dfc_sa_unet_torch.data.synthetic <dir> [--n 20] [--size 96]``
"""

import argparse
import os

import numpy as np


def samples(n: int = 20, size: int = 96, seed: int = 0):
    """Yields (name, image uint8 [size,size,3], mask uint8 [size,size] of 0/255)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        cy, cx = rng.uniform(0.25 * size, 0.75 * size, size=2)
        ry, rx = rng.uniform(0.1 * size, 0.3 * size, size=2)
        mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
        noise = rng.uniform(0, 60, size=(size, size, 3))
        img = np.where(mask[..., None], rng.uniform(150, 255, size=3), rng.uniform(0, 100, size=3))
        img = np.clip(img + noise, 0, 255).astype(np.uint8)
        yield f"sample_{i:03d}.png", img, (mask * 255).astype(np.uint8)


def generate(root: str, n: int = 20, size: int = 96, seed: int = 0) -> str:
    from PIL import Image

    img_dir = os.path.join(root, "original")
    mask_dir = os.path.join(root, "mask")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    for name, img, mask in samples(n, size, seed):
        Image.fromarray(img).save(os.path.join(img_dir, name))
        Image.fromarray(mask).save(os.path.join(mask_dir, name))
    return root


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("root")
    p.add_argument("--n", type=int, default=20)
    p.add_argument("--size", type=int, default=96)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    generate(a.root, a.n, a.size, a.seed)
    print(f"wrote {a.n} samples under {a.root}")
