"""Seeded synthetic images: ellipse blobs on a noisy background, with their masks.

The generator of the port's ``data/synthetic.py`` (each sample: one ellipse of centre U(0.25,
0.75) x size and radii U(0.1, 0.3) x size, foreground colour U(150, 255), background U(0, 100) per
channel, uniform noise U(0, 60) on every pixel, clipped to uint8), in bulk on the device from a
``torch.Generator`` and for any height and width.  The same seed gives the same images on the same
device.
"""

import torch


def ellipses(n: int, height: int, width: int, seed: int, device) -> tuple:
    """(images uint8 [n,H,W,3], masks uint8 [n,H,W] of 0/255) on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)

    def u(lo, hi, *shape):
        return torch.rand(*shape, generator=gen, device=device) * (hi - lo) + lo

    size = torch.tensor([height, width], device=device, dtype=torch.float32)
    centre = u(0.25, 0.75, n, 2) * size
    radii = u(0.1, 0.3, n, 2) * size
    yy = torch.arange(height, device=device, dtype=torch.float32).view(1, height, 1)
    xx = torch.arange(width, device=device, dtype=torch.float32).view(1, 1, width)
    dy = (yy - centre[:, 0].view(n, 1, 1)) / radii[:, 0].view(n, 1, 1)
    dx = (xx - centre[:, 1].view(n, 1, 1)) / radii[:, 1].view(n, 1, 1)
    inside = (dy.square() + dx.square()) <= 1.0
    fg, bg = u(150, 255, n, 1, 1, 3), u(0, 100, n, 1, 1, 3)
    img = torch.where(inside.unsqueeze(-1), fg, bg) + u(0, 60, n, height, width, 3)
    images = img.clamp(0, 255).to(torch.uint8)
    return images, inside.to(torch.uint8) * 255
