"""Row (spatial) sharding: each process of a spatial group holds a band of image rows.

JAX shards image rows over the ``'spatial'`` axis of its serving mesh and lets GSPMD insert the
halo ``collective-permute``s and the all-reduces (dfc_sa_unet_tpu/parallel/mesh.py:36-59).  The
port places them by hand, one process per band:

* every 3x3 conv (padding 1) exchanges one row with each neighbour (:func:`exchange_rows`, an
  autograd Function whose backward sends the halo rows' gradients back), then convolves the band
  with its two halo rows at padding (0, 1);
* the pooled attention's adaptive average pool sums each band's rows of each global window in
  f32, all-reduces the sums over the spatial group and divides by the window sizes once
  (:func:`adaptive_avg_pool_band`); the p x p map is then the same on every rank of the group;
* the attention output's bilinear upsample computes only the band's rows, from the global source
  coordinates (:func:`upsample_band`);
* 2x2 max pooling, the 2x2 transposed convs, the 1x1 convs and the skip concat are band-local;
  BatchNorm in training, the losses and the metrics reduce over the whole grid as under data
  parallelism (``nn.layers.bn_cross_replica``, ``parallel.spmd``).

The band is a ``contextvars`` context (:func:`band_context`), read by the ops
(``nn.layers.Conv``, ``ops.pooling``, ``ops.resize``, the pooled attention's upsample,
``losses``' contour, ``infer.engine``), so a model's code is unchanged.  Each autograd Function
keeps what its backward needs in ``ctx``: autograd runs the backward in its own thread on the
card, where the caller's context variables are not seen (``ops/dropout.py::remat_call`` runs a
recomputation in the forward's context).

The height rule: every band must have an even height at each of the U-Net's four pooling levels,
so the image height must be a multiple of 16 S (:func:`divides`); JAX asks only H % S == 0, since
GSPMD shards unevenly.  The callers fall back to the data axis alone where it fails.

The transports: NCCL moves the device rows (``batch_isend_irecv``); Gloo sends only host tensors,
so a CUDA row is staged through pinned host memory (the compute stays on the card).
"""

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

LEVELS = 4  # pooling levels of the U-Net family: a band's height must be even at each


def unported(what: str) -> NotImplementedError:
    """The error of a path that row sharding does not reach yet."""
    return NotImplementedError(f"row (spatial) sharding of {what} is not ported to dfc_sa_unet_torch yet "
                               f"(ROADMAP.md, Queue A 4.2)")


def divides(height: int, spatial: int) -> bool:
    """Whether ``spatial`` bands of an image of ``height`` rows are even at every pooling level."""
    return spatial > 1 and height % (spatial << LEVELS) == 0


def check_model(model) -> None:
    """Raise for a model, or a serving engine, that row sharding does not reach yet (ROADMAP.md,
    Queue A 4.2): the transformer families, UNet_FullResAttention, the vanilla UNet with
    ``bilinear: true`` and the int8 engines.  It covers the DFC family and the folded bf16/f32
    ``DFCEngine``; a module of the port's own layers elsewhere raises in the first layer that reads
    across a band (``nn.layers``, ``ops.pooling``, ``ops.resize``)."""
    from dfc_sa_unet_torch.infer.engine import DFCEngine
    from dfc_sa_unet_torch.models.ablations import UNetFullResAttention
    from dfc_sa_unet_torch.models.transunet import TransUNet
    from dfc_sa_unet_torch.models.unet import UNet
    from dfc_sa_unet_torch.models.vit_seg import VisionTransformerForSegmentation

    if isinstance(model, UNet) and model.up1.bilinear:
        raise unported("the vanilla UNet with bilinear: true (its align-corners upsample reads across bands)")
    if isinstance(model, UNetFullResAttention):
        raise unported("UNet_FullResAttention (its attention reads every pixel of the image)")
    if isinstance(model, (VisionTransformerForSegmentation, TransUNet)):
        raise unported(f"{type(model).__name__} (its tokens cross the bands)")
    if isinstance(model, DFCEngine) and type(model) is not DFCEngine:
        raise unported(f"the int8 engines ({type(model).__name__})")
    if not isinstance(model, (DFCEngine, torch.nn.Module)):
        raise unported(f"the serving engine {type(model).__name__}")


@dataclass(frozen=True)
class Band:
    """This process's band: ``index`` s of ``count`` S bands of an image of ``height`` rows, from
    row ``row0``; ``prev`` / ``next`` are the global ranks of the bands above and below (None at
    the image's edge), ``group`` the spatial subgroup of the pool's all-reduce and ``backend`` the
    transport."""
    index: int
    count: int
    height: int
    row0: int
    prev: Optional[int]
    next: Optional[int]
    group: object = None
    backend: str = "gloo"

    @property
    def rows(self) -> int:
        """The band's rows of the image (the bands are equal)."""
        return self.height // self.count

    def level(self, local_height: int):
        """(the full height, the band's first row) at a level where the band holds
        ``local_height`` rows: the bands are equal, so a level keeps the band's share."""
        return local_height * self.count, local_height * self.index


_BAND: contextvars.ContextVar = contextvars.ContextVar("row_band", default=None)


def current() -> Optional[Band]:
    """The band of the running forward, or None."""
    return _BAND.get()


@contextlib.contextmanager
def band_context(band: Optional[Band]):
    """Run the forward (and the loss) inside ``band``; None is no band."""
    token = _BAND.set(band)
    try:
        yield band
    finally:
        _BAND.reset(token)


def band_of(rank: int, spatial: int, height: int, group=None, backend: str = "gloo") -> Band:
    """The band of global ``rank`` in the grid r = d * S + s (the spatial index fastest, as JAX's
    ``reshape(n // spatial, spatial)``)."""
    s = rank % spatial
    return Band(s, spatial, height, s * (height // spatial), rank - 1 if s > 0 else None,
                rank + 1 if s < spatial - 1 else None, group, backend)


# ------------------------------------------------------------------ collectives


class _AllReduceSum(torch.autograd.Function):
    """The sum over ``group``; its backward sums the incoming gradients over the same group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the processes of ``group`` (the default group when None), differentiable."""
    return _AllReduceSum.apply(x, group)


def _swap(band: Band, to_prev: torch.Tensor, to_next: torch.Tensor):
    """Send ``to_prev`` to the band above and ``to_next`` to the band below; returns what they sent
    this band (from_prev, from_next), zeros at the image's edges."""
    from_prev = torch.zeros(to_prev.shape, dtype=to_prev.dtype, device=to_prev.device)
    from_next = torch.zeros(to_next.shape, dtype=to_next.dtype, device=to_next.device)
    if band.backend == "nccl":
        ops = []
        for peer, send, recv in ((band.prev, to_prev, from_prev), (band.next, to_next, from_next)):
            if peer is not None:
                ops += [dist.P2POp(dist.isend, send.contiguous(), peer), dist.P2POp(dist.irecv, recv, peer)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return from_prev, from_next
    # Gloo sends host tensors only: a CUDA row goes through pinned host memory
    staged = to_prev.is_cuda

    def host(t):
        if not staged:
            return t.contiguous()
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)

    reqs, landed = [], []
    for peer, send, recv in ((band.prev, to_prev, from_prev), (band.next, to_next, from_next)):
        if peer is None:
            continue
        out = host(send)
        buf = torch.empty(recv.shape, dtype=recv.dtype, pin_memory=staged) if staged else recv
        reqs += [dist.isend(out, peer), dist.irecv(buf, peer)]
        landed.append((recv, buf, out))
    for req in reqs:
        req.wait()
    for recv, buf, _ in landed:
        if buf is not recv:
            recv.copy_(buf)
    return from_prev, from_next


class _ExchangeRows(torch.autograd.Function):
    """(top, bottom): the last row of the band above and the first row of the band below (zeros
    at the image's edges).  The backward sends the halo rows' gradients back and adds what the
    neighbours send to this band's first and last rows."""

    @staticmethod
    def forward(ctx, x, band):
        ctx.band, ctx.shape = band, x.shape
        return _swap(band, x[:, :, :1], x[:, :, -1:])

    @staticmethod
    def backward(ctx, g_top, g_bottom):
        to_first, to_last = _swap(ctx.band, g_top, g_bottom)
        dx = to_first.new_zeros(ctx.shape)
        dx[:, :, :1] += to_first
        dx[:, :, -1:] += to_last  # the same row as the first where the band holds one
        return dx, None


def exchange_rows(x: torch.Tensor, band: Optional[Band] = None):
    """The halo rows of NCHW ``x`` under ``band`` (default: the current one): (top, bottom), each
    [B, C, 1, W] in x's dtype, zeros at the image's top and bottom; differentiable."""
    band = band or current()
    return _ExchangeRows.apply(x, band)


# ------------------------------------------------------------------ the band ops


def conv3x3_band(x: torch.Tensor, weight: torch.Tensor, top: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """The 3x3 conv (padding 1) of a band with its halo rows: the band's rows of the conv of the
    whole image (no bias)."""
    return F.conv2d(torch.cat([top, x, bottom], 2), weight, None, 1, (0, 1))


def conv3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The 3x3 conv at padding 1 (no bias) of x, or of its band with exchanged halos under a band."""
    if current() is None:
        return F.conv2d(x, weight, None, 1, 1)
    return conv3x3_band(x, weight, *exchange_rows(x))


def _windows(size: int, p: int):
    """torch's adaptive-pool windows [floor(i size / p), ceil((i + 1) size / p)) for i < p."""
    return [((i * size) // p, -(-(i + 1) * size // p)) for i in range(p)]


def _membership(size: int, p: int, lo: int, n: int, device) -> torch.Tensor:
    """[p, n] f32: 1 where row lo + j of a ``size``-row axis lies in window i."""
    m = torch.zeros(p, n, dtype=torch.float32)
    for i, (a, b) in enumerate(_windows(size, p)):
        a, b = max(a, lo), min(b, lo + n)
        if a < b:
            m[i, a - lo:b - lo] = 1.0
    return m.to(device)


def pool_window_sums(x: torch.Tensor, p: int, height: int, row0: int) -> torch.Tensor:
    """[B, C, p, p] f32: the sums over rows row0.. of x (a band of an image of ``height`` rows) of
    each window of the p x p adaptive average pool."""
    h, w = x.shape[2:]
    rows = _membership(height, p, row0, h, x.device)
    cols = _membership(w, p, 0, w, x.device)
    return torch.matmul(rows, torch.matmul(x.float(), cols.t()))


def pool_window_sizes(height: int, width: int, p: int, device) -> torch.Tensor:
    """[p, p] f32: the pixels of each window."""
    rows = torch.tensor([b - a for a, b in _windows(height, p)], dtype=torch.float32)
    cols = torch.tensor([b - a for a, b in _windows(width, p)], dtype=torch.float32)
    return torch.outer(rows, cols).to(device)


def adaptive_avg_pool_band(x: torch.Tensor, p: int, band: Optional[Band] = None) -> torch.Tensor:
    """The p x p adaptive average pool of the whole image from its band x: each band's f32 window
    sums, one all-reduce over the spatial group, the division by the window sizes, one rounding to
    x's dtype (the single-device pool's rounding).  The same map on every rank of the group."""
    band = band or current()
    height, row0 = band.level(x.shape[2])
    sums = all_reduce_sum(pool_window_sums(x, p, height, row0), band.group)
    return (sums / pool_window_sizes(height, x.shape[3], p, x.device)).to(x.dtype)


def _taps(size: int, n_out: int, lo: int, n: int, device) -> torch.Tensor:
    """[n, size] f32: torch's bilinear taps (align_corners False: the source index (i + 0.5) size /
    n_out - 0.5 clamped at 0, the upper tap clamped to size - 1) of outputs lo .. lo + n - 1."""
    t = torch.zeros(n, size, dtype=torch.float32)
    scale = np.float32(size) / np.float32(n_out)  # in f32, as torch's kernel computes it
    for j in range(n):
        src = float(max(scale * np.float32(lo + j + 0.5) - np.float32(0.5), np.float32(0.0)))
        y0 = min(int(src), size - 1)
        y1 = min(y0 + 1, size - 1)
        frac = src - y0
        t[j, y0] += 1.0 - frac
        t[j, y1] += frac
    return t.to(device)


def upsample_rows(o: torch.Tensor, height: int, row0: int, rows: int, width: int) -> torch.Tensor:
    """Rows row0 .. row0 + rows - 1 of the bilinear resize (align_corners False) of o [B, C, p, q]
    to height x width, in f32 (no full map is made)."""
    ry = _taps(o.shape[2], height, row0, rows, o.device)
    rx = _taps(o.shape[3], width, 0, width, o.device)
    return torch.matmul(torch.matmul(ry, o.float()), rx.t())


def upsample_band(o: torch.Tensor, size) -> torch.Tensor:
    """The pooled attention's upsample of the p x p map o to the band of ``size`` (its local rows x
    the width): the band's rows of the whole image's resize, rounded once to o's dtype."""
    band = current()
    h, w = int(size[0]), int(size[1])
    height, row0 = band.level(h)
    if (height, w) == tuple(o.shape[2:]):
        return o[:, :, row0:row0 + h]
    return upsample_rows(o, height, row0, h, w).to(o.dtype)
