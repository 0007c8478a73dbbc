"""Row (spatial) sharding: each process of a spatial group holds a band of image rows.

JAX shards image rows over the ``'spatial'`` axis of its serving mesh and lets GSPMD insert the
halo ``collective-permute``s, the all-reduces and the all-gathers (dfc_sa_unet_tpu/parallel/
mesh.py:36-59).  The port places them by hand, one process per band:

* a conv, a max pool or a transposed conv whose window reaches past the band's rows exchanges
  those rows with its neighbours (:func:`exchange_rows`: k rows above and k' below, ``fill`` past
  the image's edge; an autograd Function whose backward sends the halo rows' gradients back), then
  runs on the band with its halo rows at row padding 0 (:func:`window_rows`, :func:`conv2d`,
  :func:`conv_transpose`): a 3x3 conv at padding 1 reads one row each side;
* the pooled attention's adaptive average pool sums each band's rows of each global window in
  f32, all-reduces the sums over the spatial group and divides by the window sizes once
  (:func:`adaptive_avg_pool_band`); the p x p map is then the same on every rank of the group;
* a bilinear resize computes only the band's rows, from the global source coordinates and at
  most one halo row each side (:func:`resize_band`; the attention's upsample, whose p x p map is
  whole on every rank, :func:`upsample_band`); GroupNorm takes its statistics over the group in
  two passes (:func:`group_stats`);
* what mixes every row, a transformer's tokens or the full-resolution attention's keys, runs on
  the whole map, gathered on every rank of the group (:func:`all_gather_rows`, whose backward is a
  reduce-scatter);
* 2x2 max pooling, the 2x2 transposed convs, the 1x1 convs and the skip concat are band-local;
  BatchNorm in training, the losses and the metrics reduce over the whole grid as under data
  parallelism (``nn.layers.bn_cross_replica``, ``parallel.spmd``).

The band is a ``contextvars`` context (:func:`band_context`), read by the ops
(``nn.layers``, ``ops.pooling``, ``ops.resize``, the attention, the transformers' token stage,
``losses``' contour, the serving engines), so a model's code is unchanged.  Each autograd Function
keeps what its backward needs in ``ctx``: autograd runs the backward in its own thread on the
card, where the caller's context variables are not seen (``ops/dropout.py::remat_call`` runs a
recomputation in the forward's context).

The height rule: every band must hold whole rows at the family's coarsest grid, the U-Net's
bottleneck (four pooling levels), TransUNet's 1/16 tokens or ViT-seg's patches, so the image
height must be a multiple of S times the family's stride (:func:`divides`, :func:`family_stride`);
JAX asks only H % S == 0, since GSPMD shards unevenly.  The callers fall back to the data axis
alone where it fails.

The transports: NCCL moves the device rows (``batch_isend_irecv``, ``all_gather_into_tensor``,
``reduce_scatter_tensor``); Gloo sends only host tensors, so a CUDA row or band is staged through
host memory (the compute stays on the card).
"""

import contextlib
import contextvars
import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

FAMILY_STRIDE = 16  # the U-Net family's four pooling levels, TransUNet's 1/16 tokens


def unported(what: str) -> NotImplementedError:
    """The error of what the band ops do not cover: a layer's window, or a foreign serving callable."""
    return NotImplementedError(f"row (spatial) sharding of {what} is not supported: the band ops cover the "
                               f"port's layers, engines and windows")


def family_stride(model) -> int:
    """The rows of the image that one row of the family's coarsest grid spans: a model's or an
    engine's ``band_stride`` (ViT-seg: its patch; TransUNet: 16 times its patch), else 16."""
    return int(getattr(model, "band_stride", FAMILY_STRIDE))


def divides(height: int, spatial: int, stride: int = FAMILY_STRIDE) -> bool:
    """Whether ``spatial`` bands of an image of ``height`` rows hold whole rows of the family's
    coarsest grid (``stride`` rows each)."""
    return spatial > 1 and height % (spatial * stride) == 0


def check_model(model) -> None:
    """Raise for a callable that is neither a module nor one of the port's serving engines: the
    band ops live in the port's layers and engines, so a foreign callable would read its band as a
    whole image.  A module of the port's own layers raises in the first layer whose window the band
    ops do not cover (``nn.layers``, ``ops.pooling``)."""
    from dfc_sa_unet_torch.infer.engine import DFCEngine
    from dfc_sa_unet_torch.infer.quant import Calibrated

    if not isinstance(model, (DFCEngine, Calibrated, torch.nn.Module)):
        raise unported(f"the serving callable {type(model).__name__}")


def check_same_scales(scales: dict, group=None, device="cpu") -> None:
    """Raise unless every rank of ``group`` holds the same int8 activation scales: a band calibrated
    on its own rows would quantize with another scale than its neighbours.  ``device``: the group's
    (a CUDA device for NCCL)."""
    keys = sorted(scales)
    v = torch.tensor([float(scales[k]) for k in keys] + [float(len(keys))], dtype=torch.float64, device=device)
    lo, hi = v.clone(), v.clone()
    dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=group)
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    if not torch.equal(lo, hi):
        raise ValueError("the ranks of a spatial group hold different int8 activation scales: calibrate every "
                         "rank on the same whole images")


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


def _swap(band: Band, to_prev: torch.Tensor, to_next: torch.Tensor, fill: float = 0.0):
    """Send ``to_prev`` to the band above and ``to_next`` to the band below; returns what they sent
    this band (from_prev, from_next): the band above sends its own ``to_next``, so from_prev has
    to_next's shape, and from_next to_prev's; ``fill`` at the image's edges.  An empty tensor is
    neither sent nor received (every rank makes the same call, so both ends skip it)."""
    from_prev = torch.full(to_next.shape, fill, dtype=to_next.dtype, device=to_next.device)
    from_next = torch.full(to_prev.shape, fill, dtype=to_prev.dtype, device=to_prev.device)
    pairs = [(peer, send, recv) for peer, send, recv in ((band.prev, to_prev, from_prev), (band.next, to_next, from_next))
             if peer is not None]
    if band.backend == "nccl":
        ops = []
        for peer, send, recv in pairs:
            ops += [dist.P2POp(dist.isend, send.contiguous(), peer)] if send.numel() else []
            ops += [dist.P2POp(dist.irecv, recv, peer)] if recv.numel() else []
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
    for peer, send, recv in pairs:
        out = host(send) if send.numel() else None
        buf = (torch.empty(recv.shape, dtype=recv.dtype, pin_memory=True) if staged else recv) if recv.numel() else None
        reqs += ([dist.isend(out, peer)] if out is not None else []) + ([dist.irecv(buf, peer)] if buf is not None else [])
        landed.append((recv, buf, out))
    for req in reqs:
        req.wait()
    for recv, buf, _ in landed:
        if buf is not None and buf is not recv:
            recv.copy_(buf)
    return from_prev, from_next


class _ExchangeRows(torch.autograd.Function):
    """(top, bottom): the last ``above`` rows of the band above and the first ``below`` rows of the
    band below (``fill`` at the image's edges).  The backward sends the halo rows' gradients back
    and adds what the neighbours send to this band's first ``below`` and last ``above`` rows."""

    @staticmethod
    def forward(ctx, x, band, above, below, fill):
        h = x.shape[2]
        if max(above, below) > h:
            raise ValueError(f"a halo of {above} rows above and {below} below from bands of {h} rows: a band must "
                             f"hold the rows its neighbours read")
        ctx.band, ctx.shape, ctx.above, ctx.below = band, x.shape, above, below
        return _swap(band, x[:, :, :below], x[:, :, h - above:], fill)

    @staticmethod
    def backward(ctx, g_top, g_bottom):
        to_first, to_last = _swap(ctx.band, g_top, g_bottom)
        dx = to_first.new_zeros(ctx.shape)
        h = ctx.shape[2]
        dx[:, :, :ctx.below] += to_first
        dx[:, :, h - ctx.above:] += to_last  # rows of both halos where the band holds few
        return dx, None, None, None, None


def exchange_rows(x: torch.Tensor, band: Optional[Band] = None, above: int = 1, below: int = 1,
                  fill: float = 0.0):
    """The halo rows of NCHW ``x`` under ``band`` (default: the current one): (top, bottom), the
    ``above`` rows just above the band and the ``below`` rows just below it, [B, C, k, W] in x's
    dtype, ``fill`` past the image's top and bottom (a conv's zeros, a max pool's -inf);
    differentiable.  The 3x3 convs' exchange is the default, one row each side."""
    band = band or current()
    return _ExchangeRows.apply(x, band, above, below, fill)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class _AllGatherRows(torch.autograd.Function):
    """The whole map's rows from every band's, in band order, on every rank of the band's group.
    The backward is a reduce-scatter: the sum over the group of every rank's gradient of the whole
    map, then this band's rows.  Every rank computes the same loss from global sums (the
    ``all_reduce_sum`` convention), so the sum is the band's share of the gradient scaled as the
    rest of the step's gradients are."""

    @staticmethod
    def forward(ctx, x, band):
        ctx.band = band
        xn = _nhwc(x)  # [B, h, W, C]: a band is a contiguous block of every image
        s = band.count
        if band.backend == "nccl":
            out = xn.new_empty((s,) + tuple(xn.shape))
            dist.all_gather_into_tensor(out, xn, group=band.group)
        else:  # Gloo: through host memory
            part = xn.cpu()
            parts = [torch.empty_like(part) for _ in range(s)]
            dist.all_gather(parts, part, group=band.group)
            out = torch.stack(parts).to(x.device)
        b, h, w, c = xn.shape
        whole = out.permute(1, 0, 2, 3, 4).reshape(b, s * h, w, c)
        return whole.permute(0, 3, 1, 2)  # NCHW, stored channels_last

    @staticmethod
    def backward(ctx, g):
        band = ctx.band
        s = band.count
        gn = _nhwc(g)
        b, hh, w, c = gn.shape
        h = hh // s
        if band.backend == "nccl":
            out = gn.new_empty((b, h, w, c))
            dist.reduce_scatter_tensor(out, gn.view(b, s, h, w, c).transpose(0, 1).contiguous(), group=band.group)
        else:
            dist.all_reduce(gn, group=band.group)
            out = gn[:, band.index * h:(band.index + 1) * h]
        return out.permute(0, 3, 1, 2), None


def all_gather_rows(x: torch.Tensor, band: Optional[Band] = None) -> torch.Tensor:
    """The whole NCHW map from its band ``x`` (default band: the current one), on every rank of the
    spatial group, stored channels_last; differentiable (the backward reduce-scatters)."""
    band = band or current()
    return _AllGatherRows.apply(x, band)


def band_rows(x: torch.Tensor, band: Optional[Band] = None) -> torch.Tensor:
    """This band's rows of a whole map ``x`` that every rank of the group holds (a view)."""
    band = band or current()
    h = x.shape[2] // band.count
    return x[:, :, band.index * h:(band.index + 1) * h]


# ------------------------------------------------------------------ the band ops


def halo_counts(kernel: int, stride: int, padding: int, rows: int, row0: int):
    """(above, below): the rows past a band of ``rows`` rows from global row ``row0`` that a window
    of ``kernel`` rows at ``stride`` and ``padding`` reads for the band's output rows
    [row0 / stride, (row0 + rows) / stride) (both multiples of the stride: the family's band rule).
    Output row o reads input rows o s - p .. o s - p + k - 1."""
    if row0 % stride or rows % stride:
        raise unported(f"a window of stride {stride} on a band of {rows} rows from row {row0}")
    o0, o1 = row0 // stride, (row0 + rows) // stride
    return max(0, row0 - (o0 * stride - padding)), max(0, (o1 - 1) * stride - padding + kernel - 1 - (row0 + rows - 1))


def window_rows(x: torch.Tensor, kernel: int, stride: int, padding: int, fill: float = 0.0,
                band: Optional[Band] = None) -> torch.Tensor:
    """The band x with the halo rows a ``kernel`` x ``stride`` window at row ``padding`` reads
    (``fill`` past the image's edges): the window then runs on it at row padding 0 and gives the
    band's output rows."""
    band = band or current()
    _, row0 = band.level(x.shape[2])
    above, below = halo_counts(kernel, stride, padding, x.shape[2], row0)
    if not above and not below:
        return x
    top, bottom = exchange_rows(x, band, above, below, fill)
    return torch.cat([top, x, bottom], 2)


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """F.conv2d (no bias) of x, or under a band its band's rows of the whole image's conv: the
    halo rows its window reads, then row padding 0."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    ph, pw = (padding, padding) if isinstance(padding, int) else padding
    if current() is None or weight.shape[2] == 1 and ph == 0:
        return F.conv2d(x, weight, None, (sh, sw), (ph, pw))
    return F.conv2d(window_rows(x, weight.shape[2], sh, ph), weight, None, (sh, sw), (0, pw))


def conv3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The 3x3 conv at padding 1 (no bias) of x, or of its band with one halo row each side."""
    return conv2d(x, weight, 1, 1)


def conv_transpose(x: torch.Tensor, weight: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
    """F.conv_transpose2d (no bias) of x at a square ``stride`` and ``padding`` (weight [Cin, Cout,
    k, k]), or under a band its band's rows of the whole image's: where the output is ``stride``
    times the input (k = s + 2p) and p <= 1, output row o reads input rows (o + p - k + 1) / s ..
    (o + p) / s, within one row of the band's; so one halo row each side, and the row padding
    p + s that aligns the band's first output row (one halo row at stride s moves it by s)."""
    k = weight.shape[2]
    if current() is None:
        return F.conv_transpose2d(x, weight, None, stride, padding)
    if k != stride + 2 * padding or padding > 1:
        raise unported(f"a transposed conv of kernel {k}, stride {stride}, padding {padding}")
    top, bottom = exchange_rows(x)
    return F.conv_transpose2d(torch.cat([top, x, bottom], 2), weight, None, stride, (padding + stride, padding))


def group_stats(xf: torch.Tensor, dims, band: Optional[Band] = None):
    """(biased variance, mean) of f32 ``xf`` over ``dims`` (keepdim) across the whole image from its
    band: the band's sums, one all-reduce over the spatial group, then the sums of squared
    deviations from the global mean, all-reduced again (two passes: one-pass E[x^2] - E[x]^2 loses
    the digits of a large mean); differentiable."""
    band = band or current()
    n = band.count
    for d in dims:
        n *= xf.shape[d]
    mean = all_reduce_sum(xf.sum(dims, keepdim=True), band.group) / n
    var = all_reduce_sum((xf - mean).square().sum(dims, keepdim=True), band.group) / n
    return var, mean


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


@functools.lru_cache(maxsize=256)
def _tap_rows(size: int, n_out: int, lo: int, n: int, align_corners: bool):
    """(lower source row, upper source row, weight of the upper) of outputs lo .. lo + n - 1 of a
    bilinear resize of ``size`` rows to ``n_out``, as torch's kernel computes them: the source index
    in f32 (align_corners False: (i + 0.5) size / n_out - 0.5 clamped at 0; True: i (size - 1) /
    (n_out - 1)), the upper row clamped to size - 1.  numpy arrays: a cached tensor made under
    inference mode could not enter a later graph."""
    if align_corners:
        scale = np.float32(size - 1) / np.float32(n_out - 1) if n_out > 1 else np.float32(0.0)
        src = scale * np.arange(lo, lo + n, dtype=np.float32)
    else:
        scale = np.float32(size) / np.float32(n_out)
        src = np.maximum(scale * (np.arange(lo, lo + n, dtype=np.float32) + np.float32(0.5)) - np.float32(0.5),
                         np.float32(0.0))
    y0 = np.minimum(src.astype(np.int64), size - 1)
    y1 = np.minimum(y0 + 1, size - 1)
    frac = (src - y0).astype(np.float32)
    for t in (y0, y1, frac):
        t.flags.writeable = False
    return y0, y1, frac


@functools.lru_cache(maxsize=256)
def _taps_np(size: int, n_out: int, lo: int, n: int, align_corners: bool) -> np.ndarray:
    """The taps of :func:`_taps` as a dense numpy array."""
    y0, y1, frac = _tap_rows(size, n_out, lo, n, align_corners)
    t = np.zeros((n, size), dtype=np.float32)
    np.add.at(t, (np.arange(n), y0), np.float32(1.0) - frac)
    np.add.at(t, (np.arange(n), y1), frac)
    t.flags.writeable = False
    return t


def _taps(size: int, n_out: int, lo: int, n: int, device, align_corners: bool = False) -> torch.Tensor:
    """[n, size] f32: torch's bilinear taps of outputs lo .. lo + n - 1 of a resize of ``size`` rows
    to ``n_out`` (align_corners False: the source index (i + 0.5) size / n_out - 0.5 clamped at 0;
    True: i (size - 1) / (n_out - 1); the upper tap clamped to size - 1)."""
    return torch.tensor(_taps_np(size, n_out, lo, n, align_corners), device=device)


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


def _lerp(x: torch.Tensor, dim: int, y0: np.ndarray, y1: np.ndarray, frac: np.ndarray) -> torch.Tensor:
    """x's rows (or columns) y0 and y1 along ``dim`` blended as (1 - frac) x[y0] + frac x[y1]."""
    shape = [1] * x.dim()
    shape[dim] = len(frac)
    f = torch.tensor(frac, device=x.device).view(shape)
    return (x.index_select(dim, torch.tensor(y0, device=x.device)) * (1.0 - f)
            + x.index_select(dim, torch.tensor(y1, device=x.device)) * f)


def resize_band(x: torch.Tensor, size, align_corners: bool = False, band: Optional[Band] = None) -> torch.Tensor:
    """The band's rows of the bilinear resize of the whole image to the band's ``size`` (its local
    rows x the width), from the band x and one halo row each side: two taps an output, the width's
    and then the global source rows' (every band holds the same share of the input and the output
    rows, so a tap lies at most one row past the band), in f32, rounded once to x's dtype."""
    band = band or current()
    h, w = x.shape[2:]
    ho, wo = int(size[0]), int(size[1])
    height, row0 = band.level(h)
    height_out, row0_out = band.level(ho)
    y0, y1, frac = _tap_rows(height, height_out, row0_out, ho, align_corners)
    if y0.min() < row0 - 1 or y1.max() > row0 + h:
        raise unported(f"a resize of {height} rows to {height_out} whose taps reach past one halo row")
    top, bottom = exchange_rows(x, band)
    xe = torch.cat([top, x, bottom], 2).float()
    if wo != w:
        xe = _lerp(xe, 3, *_tap_rows(w, wo, 0, wo, align_corners))
    return _lerp(xe, 2, y0 - (row0 - 1), y1 - (row0 - 1), frac).to(x.dtype)  # xe's row 0 is row0 - 1
