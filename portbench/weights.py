"""Seeded weights: every tensor of a configuration's state dict from one draw on the device.

The reference of a configuration names each key's shape and draw (``state_spec``); one
``torch.randn`` of all their elements, from a generator on the device seeded with the run's seed,
is cut into the tensors and scaled.  The same seed gives the same state dict on the same device.
"""

import math

import torch


def seeded_state(spec: dict, seed: int, device) -> dict:
    """{key: float32 tensor on ``device``} for ``spec`` = {key: (shape, draw)}, draw being
    ("normal", mean, std) or ("lognormal", median, sigma)."""
    sizes = [math.prod(shape) for shape, _ in spec.values()]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2**63)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for (key, (shape, draw)), n in zip(spec.items(), sizes):
        z = flat[offset:offset + n].view(shape)
        offset += n
        kind, a, b = draw
        if kind == "normal":
            out[key] = z * b + a
        elif kind == "lognormal":
            out[key] = torch.exp(z * b) * a
        else:
            raise ValueError(f"{key}: unknown draw {kind!r}")
    return out
