"""Device selection for the port's entry points.

The entry points run on the card.  Without CUDA they raise unless the
caller asked for the CPU: there is no silent CPU path.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means "cuda"; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
