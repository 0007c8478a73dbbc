"""What the checks of ``correct`` must catch, planted in a whole run from outside it, and the
witnesses that a limit's readings are explained by.  ``calibrate.py`` and the tests use them; the
benchmark's own runs never do.

    with planted("fp8"):
        result = core.run_cell(cell, seed, seconds, False, device)

The control and the reference's witness put the configuration's plain reference in the program's
place: a driver builds its program in ``_model(run, sd, ...)``, and under these plants every
driver's ``_model`` gives ``ReferenceModule`` instead, which the same Predictor or Trainer then
serves or trains.
    "fp8"             the control: every product's operands in float8 e4m3, the precision below
                      the bfloat16 that the configurations state (``reference/plain.py``)
    "bf16"            a witness: every product's operands, and the gradients that flow back
                      through them, rounded to bfloat16
The faults, in the program:
    "altered_answer"  the first tile of every answer flipped (p -> 1 - p) where it is produced
    "half_batch"      half of each batch left out, the mean taken over the rest
    "unchanged"       the optimiser's step leaves the parameters as they were
A witness of the program:
    "upsample_f32"    the pooled attention's bilinear upsample, and so its backward, in float32
"""

import contextlib
import importlib
import pkgutil

import torch

from portbench import drivers

PLANTS = ("fp8", "bf16", "altered_answer", "half_batch", "unchanged", "upsample_f32")


class ReferenceModule(torch.nn.Module):
    """The configuration's plain reference as a module: the seeded state dict's tensors as its
    parameters and (the running statistics) buffers, under the same keys, and its forward the
    reference's in ``precision``.  In training mode it normalises with the batch's statistics and
    moves the running statistics as BatchNorm does."""

    def __init__(self, run, sd, precision):
        super().__init__()
        self.reference, self.config, self.precision = run.reference, run.config, precision
        for key, value in sd.items():
            *path, leaf = key.split(".")
            owner = self
            for part in path:
                if part not in owner._modules:
                    owner.add_module(part, torch.nn.Module())
                owner = owner._modules[part]
            t = value.detach().to(run.device, torch.float32, copy=True)
            if key.endswith(("running_mean", "running_var")):
                owner.register_buffer(leaf, t)
            else:
                owner.register_parameter(leaf, torch.nn.Parameter(t))

    def forward(self, x):
        state = {**dict(self.named_parameters()), **dict(self.named_buffers())}
        model = self.reference.Model(self.config, state, train=self.training, precision=self.precision,
                                     checkpoint=self.training)
        out = model(x.float())
        if self.training:
            with torch.no_grad():
                for key, value in model.norms.moved().items():
                    state[key].copy_(value)
        return out


def _driver_models(precision):
    """(module, "_model", the reference in ``precision``) for every driver that builds a program."""
    out = []
    for info in pkgutil.iter_modules(drivers.__path__):
        module = importlib.import_module(f"{drivers.__name__}.{info.name}")
        if hasattr(module, "_model"):
            out.append((module, "_model", lambda run, sd, *rest: ReferenceModule(run, sd, precision)))
    return out


def _patches(name):
    if name in ("fp8", "bf16"):
        return _driver_models(name)
    if name == "altered_answer":
        from dfc_sa_unet_torch.infer.predictor import Predictor

        def predict_probs(self, images_u8, _orig=Predictor.predict_probs):
            out = _orig(self, images_u8)
            out[0] = 1.0 - out[0]
            return out

        return [(Predictor, "predict_probs", predict_probs)]
    if name == "half_batch":
        from dfc_sa_unet_torch.train.trainer import Trainer

        def train_step(self, images_u8, masks_u8, *args, _orig=Trainer.train_step, **kwargs):
            n = int(images_u8.shape[0]) // 2
            return _orig(self, images_u8[:n], masks_u8[:n], *args, **kwargs)

        return [(Trainer, "train_step", train_step)]
    if name == "unchanged":
        from dfc_sa_unet_torch.train.optim import SGDWithClip

        return [(SGDWithClip, "step", lambda self: None)]
    if name == "upsample_f32":
        from dfc_sa_unet_torch.models import blocks

        def upsample_pooled(o, size, _orig=blocks.upsample_pooled):
            return _orig(o.float(), size).to(o.dtype)

        return [(blocks, "upsample_pooled", upsample_pooled)]
    raise ValueError(f"unknown plant {name!r}; one of {PLANTS}")


@contextlib.contextmanager
def planted(name):
    """Inside the context, the plant ``name`` (one of ``PLANTS``, or None for none) is in place."""
    patches = _patches(name) if name else []
    saved = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
    try:
        for owner, attr, value in patches:
            setattr(owner, attr, value)
        yield
    finally:
        for owner, attr, value in saved:
            setattr(owner, attr, value)
