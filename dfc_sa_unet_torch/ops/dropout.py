"""Dropout that draws from an explicit ``torch.Generator``, and
rematerialisation that replays it.

``F.dropout`` reads the global RNG; the trainer hands its own generator
down instead (``set_dropout_generator``), so a training step depends on
the trainer's seed and step alone and a resumed run repeats it.  With no
generator set, the global RNG is used.

``remat_call`` wraps ``torch.utils.checkpoint`` (``use_reentrant=False``):
the backward runs the function a second time, and that second run must see
the same dropout masks and must not move BatchNorm's running statistics
again.  It rewinds the generator for the recomputation and raises a flag
that ``nn.layers.BatchNorm`` reads (``recomputing()``).
"""

import torch
from torch.utils.checkpoint import checkpoint

_RECOMPUTING = [False]


def dropout(x: torch.Tensor, p: float, training: bool, generator=None) -> torch.Tensor:
    """Inverted dropout: zero with probability ``p``, scale the rest by 1/(1-p)."""
    if not training or p <= 0.0:
        return x
    keep = torch.rand(x.shape, device=x.device, generator=generator) >= p
    return x * keep.to(x.dtype) * (1.0 / (1.0 - p))


def set_dropout_generator(model: torch.nn.Module, generator) -> None:
    """Every module of ``model`` draws its dropout masks from ``generator``
    (on the model's device) from now on; ``None`` returns to the global RNG."""
    for mod in model.modules():
        mod.dropout_generator = generator


def dropout_generator(module: torch.nn.Module):
    return getattr(module, "dropout_generator", None)


def recomputing() -> bool:
    """True while a rematerialised block runs for the second time."""
    return _RECOMPUTING[0]


def remat_call(fn, *args, generator=None):
    """``fn(*args)`` whose activations are recomputed in the backward pass."""
    state = None if generator is None else generator.get_state()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        keep = None
        if generator is not None:
            keep = generator.get_state()
            generator.set_state(state)
        was, _RECOMPUTING[0] = _RECOMPUTING[0], True
        try:
            return fn(*a)
        finally:
            _RECOMPUTING[0] = was
            if keep is not None:
                generator.set_state(keep)

    # the global RNG is saved and restored by checkpoint itself; a generator is handled above
    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=generator is None)


def call_block(owner: torch.nn.Module, remat: bool, mod, *args):
    """``mod(*args)``, rematerialised when ``remat`` is set and gradients are
    on; ``owner`` is the module whose dropout generator the block draws from."""
    if remat and torch.is_grad_enabled():
        return remat_call(mod, *args, generator=dropout_generator(owner))
    return mod(*args)
