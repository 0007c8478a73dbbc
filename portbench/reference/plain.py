"""Plain float32 pieces that the references share: the input normalisation, BatchNorm, the
precision of the products, the loss and the optimiser step of the configurations' recipe.

Everything here is written from the published recipe (ImageNet normalisation, BatchNorm with eps
1e-5 and momentum 0.1, BCE + Dice, SGD with momentum, weight decay and a global-norm clip of 1.0)
in plain torch.  Nothing of the program under test is imported.

``Precision`` says how the operands of every product (convolution, linear layer, attention
product) are rounded before it: ``None`` leaves them in float32; ``"fp8"`` rounds each operand to
float8 e4m3 with one scale a tensor (its largest magnitude to 448), the precision below the
bfloat16 that the configurations state, which the checks' control computes in, its rounding
passing the gradient straight through; ``"bf16"`` rounds them to bfloat16 and the gradient that
flows back through them too, a witness of what bfloat16 tensors alone do to a compared number.
"""

import contextlib

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 products in float32 inside the context: no TF32 in cuBLAS or cuDNN."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W,3] -> float32 [B,3,H,W]: x / 255, then (x - mean) / std."""
    x = images_u8.float().permute(0, 3, 1, 2) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def _round_fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t.detach())


class _RoundBf16(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(torch.bfloat16).to(grad.dtype)


_ROUNDING = {"fp8": _round_fp8, "bf16": _RoundBf16.apply}


class Precision:
    """The rounding of every product's operands: ``None`` (float32), ``"fp8"`` or ``"bf16"``."""

    def __init__(self, name=None):
        if name is not None and name not in _ROUNDING:
            raise ValueError(f"precision {name!r}: None, 'fp8' or 'bf16'")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.name is None else _ROUNDING[self.name](t)

    def conv(self, x, w, b=None, stride=1, padding=0):
        return F.conv2d(self(x), self(w), b, stride, padding)

    def conv_transpose(self, x, w, b, stride):
        return F.conv_transpose2d(self(x), self(w), b, stride)

    def linear(self, x, w, b=None):
        return F.linear(self(x), self(w), b)

    def matmul(self, a, b):
        return torch.matmul(self(a), self(b))


class Norms:
    """BatchNorm over a state dict: eval mode reads the running statistics; training mode
    normalises with the batch's biased variance and records, under the layer's prefix, the batch
    mean and unbiased variance that move the running statistics (``moved``)."""

    def __init__(self, sd, train: bool):
        self.sd, self.train, self.batch = sd, train, {}

    def __call__(self, x, prefix):
        w, b = self.sd[f"{prefix}.weight"], self.sd[f"{prefix}.bias"]
        if not self.train:
            return F.batch_norm(x, self.sd[f"{prefix}.running_mean"], self.sd[f"{prefix}.running_var"], w, b,
                                False, 0.0, BN_EPS)
        var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
        n = x.numel() / x.shape[1]
        self.batch[prefix] = (mean.detach(), var.detach() * n / (n - 1))
        shape = (1, -1, 1, 1)
        return (x - mean.view(shape)) * torch.rsqrt(var.view(shape) + BN_EPS) * w.view(shape) + b.view(shape)

    def moved(self) -> dict:
        """The running statistics after this step: {key: tensor} for every BatchNorm that ran."""
        out = {}
        for prefix, (mean, var) in self.batch.items():
            for key, new in (("running_mean", mean), ("running_var", var)):
                old = self.sd[f"{prefix}.{key}"].detach()
                out[f"{prefix}.{key}"] = (1.0 - BN_MOMENTUM) * old + BN_MOMENTUM * new
        return out


def _clamped_log(p: torch.Tensor, at_end: torch.Tensor) -> torch.Tensor:
    """log(p) clamped at -100, as torch's BCELoss; where ``at_end`` (p has reached 0) the value
    -100 with no gradient, as the configurations' trainers take it."""
    safe = torch.where(at_end, torch.ones_like(p), p)
    return torch.where(at_end, torch.full_like(p, -100.0), torch.log(safe).clamp(min=-100.0))


def bce_dice_loss(probs, target, bce_weight=0.5, dice_weight=0.5):
    """Mean BCE (log terms clamped at -100, as torch's BCELoss; a probability of exactly 0 or 1
    passes no gradient) plus the soft Dice loss of the flattened batch with smoothing 1."""
    p, t = probs.float(), target.float()
    bce = -(t * _clamped_log(p, p <= 0.0) + (1.0 - t) * _clamped_log(1.0 - p, p >= 1.0)).mean()
    inter = (p * t).sum()
    dice = 1.0 - (2.0 * inter + 1.0) / (p.sum() + t.sum() + 1.0)
    return bce_weight * bce + dice_weight * dice


def masks_to_target(masks_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B,H,W] masks -> {0,1} float [B,1,H,W] (v / 255 > 0.5)."""
    return (masks_u8.float() / 255.0 > 0.5).float().unsqueeze(1)


@torch.no_grad()
def sgd_step(params: dict, grads: dict, momentum_buf: dict, lr, momentum, weight_decay, clip=1.0) -> dict:
    """One step of SGD with momentum and weight decay after a clip of the gradients to a global
    norm of ``clip`` (scale clip / max(norm, clip)).  Updates ``params`` and ``momentum_buf`` in
    place; returns the direction the step took for each parameter (the gradient as the optimiser
    has it: clipped, with the decay added, before the momentum)."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
    scale = clip / torch.clamp(norm, min=clip)
    direction = {}
    for name, p in params.items():
        d = grads[name] * scale + weight_decay * p
        direction[name] = d.clone()
        buf = momentum_buf.get(name)
        buf = d.clone() if buf is None else buf.mul_(momentum).add_(d)
        momentum_buf[name] = buf
        p.sub_(lr * buf)
    return direction
