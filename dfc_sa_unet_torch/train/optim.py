"""The optimiser of the reference's training recipe (counterpart of
dfc_sa_unet_tpu/train/optim.py).

Gradients are clipped to a global norm of 1.0, then torch.optim.SGD's own
order of operations:

    g   = g * clip / max(norm, clip)      the trainer's clip
    d   = g + weight_decay * p            torch SGD: d_p += wd * p
    buf = momentum * buf + d              (buf starts at 0, so step 1 gives d)
    p   = p - lr * buf

The clip is optax's ``clip_by_global_norm`` (scale ``clip / max(norm,
clip)``), not ``torch.nn.utils.clip_grad_norm_`` (``clip / (norm + 1e-6)``):
the two differ by a part in a million above the clip norm, and the JAX
trainer, which the port is held against, uses the former.  Everything stays
on the device: a step makes no host synchronisation.
"""

from typing import Dict, Iterable, Optional

import torch


class SGDWithClip:
    """SGD with momentum, weight decay and a global-norm clip over named
    parameters.  ``momentum_buffers`` maps a parameter's name to its buffer
    (created at the first step), so state is saved and restored by name."""

    def __init__(self, named_params: Iterable, learning_rate: float, momentum: float = 0.9,
                 weight_decay: float = 1e-4, clip_norm: Optional[float] = 1.0):
        self.named_params = [(n, p) for n, p in named_params if p.requires_grad]
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm
        self.momentum_buffers: Dict[str, torch.Tensor] = {}

    def zero_grad(self):
        for _, p in self.named_params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        """One update from the parameters' ``.grad`` (a parameter without one is left alone)."""
        named = [(n, p) for n, p in self.named_params if p.grad is not None]
        if not named:
            return
        params = [p for _, p in named]
        grads = [p.grad for p in params]
        if self.clip_norm is not None:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            grads = torch._foreach_mul(grads, self.clip_norm / torch.clamp(norm, min=self.clip_norm))
        if self.weight_decay:
            grads = torch._foreach_add(grads, params, alpha=self.weight_decay)
        if self.momentum:
            bufs = []
            for (name, _), g in zip(named, grads):
                if name not in self.momentum_buffers:
                    self.momentum_buffers[name] = torch.zeros_like(g)
                bufs.append(self.momentum_buffers[name])
            torch._foreach_mul_(bufs, self.momentum)
            torch._foreach_add_(bufs, grads)
            grads = bufs
        torch._foreach_add_(params, grads, alpha=-self.learning_rate)

    def state_dict(self) -> dict:
        return {"momentum_buffers": {k: v.clone() for k, v in self.momentum_buffers.items()}}

    def load_state_dict(self, state: dict):
        by_name = dict(self.named_params)
        self.momentum_buffers = {}
        for name, buf in state["momentum_buffers"].items():
            p = by_name[name]
            self.momentum_buffers[name] = torch.as_tensor(buf).to(device=p.device, dtype=p.dtype).reshape(p.shape).clone()


def from_config(config, named_params) -> SGDWithClip:
    tr = config["training"]
    return SGDWithClip(named_params, learning_rate=float(tr.get("learning_rate", 0.01)),
                         momentum=float(tr.get("momentum", 0.9)),
                         weight_decay=float(tr.get("weight_decay", 1e-4)), clip_norm=1.0)
