"""The band ops of row (spatial) sharding in one process, with no group: a whole tensor is cut
into bands, each band is handed its neighbours' rows, and the stitched band outputs are held
against the op on the whole tensor (parallel/rows.py; the collectives are the 2- and 4-process
tests' part: tests/test_torch_rows_training.py, _serving.py, _grid.py, _cli.py).

The 3x3 conv at padding (0, 1) with the halo rows, the adaptive average pool's window sums at sizes
the windows straddle the bands (28 rows to 8, 7 to 2, and p > H), the attention upsample's band
rows, the Laplacian contour of ``joint``, and the plain versions of the two kernels that take halo
rows (``conv3x3_bn_relu_plain``, ``dfc_tail_plain`` with ``top`` and ``bottom``), which also match
the JAX Pallas kernels (interpret mode) on the whole image at tests/test_torch_dfc_tail.py's limits.
f32 within 1e-6 of max|reference|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dfc_sa_unet_tpu.ops.pallas_conv import conv3x3_bn_relu as jax_conv3x3, dfc_tail_from_x
from dfc_sa_unet_torch.losses import _LAPLACIAN
from dfc_sa_unet_torch.ops.dfc_tail import conv3x3_bn_relu, conv3x3_bn_relu_plain, dfc_tail, dfc_tail_plain
from dfc_sa_unet_torch.parallel import rows

torch.set_num_threads(2)
CUTS = {"2 bands": [8, 8], "4 bands": [4, 4, 4, 4], "1 row, odd": [1, 5, 10]}


def close(got, want, rel=1e-6):
    want = torch.as_tensor(want).double()
    err = (torch.as_tensor(got).double() - want).abs().max().item()
    assert err <= rel * max(want.abs().max().item(), 1e-30), err


def bands(h, cuts):
    """(first row, last row + 1) of each band."""
    edges = np.cumsum([0] + list(cuts))
    assert edges[-1] == h
    return list(zip(edges[:-1], edges[1:]))


def halo_nchw(x, r0, r1):
    """The rows above and below rows r0..r1 - 1 of NCHW x, zeros at the image's edges."""
    zero = torch.zeros_like(x[:, :, :1])
    return (x[:, :, r0 - 1:r0] if r0 > 0 else zero), (x[:, :, r1:r1 + 1] if r1 < x.shape[2] else zero)


@pytest.mark.parametrize("cut", CUTS)
def test_band_conv_with_halo_rows_is_the_whole_conv(cut):
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 16, 11)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((7, 5, 3, 3)).astype(np.float32))
    want = F.conv2d(x, w, padding=1)
    got = torch.cat([rows.conv3x3_band(x[:, :, r0:r1], w, *halo_nchw(x, r0, r1)) for r0, r1 in bands(16, CUTS[cut])],
                    2)
    close(got, want)
    # the contour of the joint loss is this conv with the Laplacian kernel
    lap = torch.tensor(_LAPLACIAN).reshape(1, 1, 3, 3)
    p = x[:, :1].sigmoid()
    close(torch.cat([rows.conv3x3_band(p[:, :, r0:r1], lap, *halo_nchw(p, r0, r1)) for r0, r1 in bands(16, CUTS[cut])],
                    2), F.conv2d(p, lap, padding=1))
    assert rows.current() is None
    close(rows.conv3x3(x, w), want)  # no band: the whole conv


@pytest.mark.parametrize("h,w,p,cuts", [(28, 20, 8, [14, 14]), (28, 20, 8, [7, 7, 7, 7]), (7, 9, 2, [1, 3, 3]),
                                        (2, 6, 3, [1, 1]), (32, 32, 2, [16, 16])])
def test_band_pool_sums_are_the_whole_adaptive_pool(h, w, p, cuts):
    """Windows [floor(i H / p), ceil((i + 1) H / p)) straddle the bands (28 rows to 8: windows of 3 to 4
    rows; 7 to 2; 2 to 3, overlapping one-row windows): each band's f32 sums, added, over the sizes."""
    x = torch.from_numpy(np.random.default_rng(h * p).standard_normal((2, 3, h, w)).astype(np.float32))
    sums = sum(rows.pool_window_sums(x[:, :, r0:r1], p, h, r0) for r0, r1 in bands(h, cuts))
    got = sums / rows.pool_window_sizes(h, w, p, x.device)
    close(got, F.adaptive_avg_pool2d(x, (p, p)))
    # bf16: f32 sums, one rounding after the division, as the single-device pool
    xb = x.bfloat16()
    sums = sum(rows.pool_window_sums(xb[:, :, r0:r1], p, h, r0) for r0, r1 in bands(h, cuts))
    got = (sums / rows.pool_window_sizes(h, w, p, x.device)).bfloat16()
    assert got.dtype == torch.bfloat16
    close(got.float(), F.adaptive_avg_pool2d(xb.float(), (p, p)).bfloat16().float(), rel=2 ** -7)


@pytest.mark.parametrize("p,h,w,cuts", [(8, 28, 20, [14, 14]), (8, 28, 28, [1, 13, 14]), (2, 7, 9, [3, 4]),
                                        (3, 2, 5, [1, 1]), (2, 2, 2, [1, 1])])
def test_band_upsample_rows_are_the_whole_resize(p, h, w, cuts):
    """The attention output's bilinear upsample (align_corners False) computed for a band's rows only,
    from the global source coordinates; p == H is the identity."""
    o = torch.from_numpy(np.random.default_rng(p * h).standard_normal((2, 3, p, p)).astype(np.float32))
    want = F.interpolate(o, size=(h, w), mode="bilinear", align_corners=False)
    got = torch.cat([rows.upsample_rows(o, h, r0, r1 - r0, w) for r0, r1 in bands(h, cuts)], 2)
    close(got, want)


def test_height_rule_and_the_grid():
    assert rows.divides(224, 2) and not rows.divides(224, 4) and rows.divides(2048, 8)
    assert not rows.divides(48, 2) and not rows.divides(32, 1)
    b = rows.band_of(5, 2, 64)  # data index 2, spatial index 1 of 2: the lower band
    assert (b.index, b.count, b.row0, b.prev, b.next) == (1, 2, 32, 4, None)
    b = rows.band_of(2, 4, 64)
    assert (b.index, b.row0, b.prev, b.next) == (2, 32, 1, 3)
    assert b.level(4) == (16, 8)  # a level where the band holds 4 rows


def _nhwc_halo(x, r0, r1):
    """NHWC x's rows above and below rows r0..r1 - 1, as the kernels take them ([B,W,C]; None at the edge)."""
    return (x[:, r0 - 1].contiguous() if r0 > 0 else None), (x[:, r1].contiguous() if r1 < x.shape[1] else None)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("cut", CUTS)
def test_plain_conv3x3_bn_relu_with_halo_rows(cut):
    rng = np.random.default_rng(3)
    x, k, bias = _rand(rng, (2, 16, 8, 12)), _rand(rng, (3, 3, 12, 10), 0.1), _rand(rng, (10,))
    xt, kt, bt = (torch.from_numpy(t) for t in (x, k, bias))
    whole = conv3x3_bn_relu_plain(xt, kt, bt)
    parts = [conv3x3_bn_relu(xt[:, r0:r1].contiguous(), kt, bt, *_nhwc_halo(xt, r0, r1))
             for r0, r1 in bands(16, CUTS[cut])]
    close(torch.cat(parts, 1), whole)
    want = np.asarray(jax_conv3x3(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias), interpret=True))
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("cin,c", [(12, 10), (10, 10)])
def test_plain_dfc_tail_with_halo_rows(cut, cin, c):
    """The band's tail reads its neighbours' rows in the 3x3 conv only; a and the residual's x are
    the band's own rows."""
    rng = np.random.default_rng(cin * c)
    wr = _rand(rng, (cin, c), 0.1) if cin != c else np.eye(c, dtype=np.float32) * np.float32(0.1)
    args = [_rand(rng, (2, 16, 8, cin)), _rand(rng, (2, 16, 8, c)), _rand(rng, (3, 3, cin, c), 0.1),
            _rand(rng, (c,)), _rand(rng, (2 * c, c), 0.1), _rand(rng, (c,)),
            _rand(rng, (3 * c, c), 0.1), _rand(rng, (c,)), wr]
    x, a, *weights = (torch.from_numpy(t) for t in args)
    whole = dfc_tail_plain(x, a, *weights)
    parts = [dfc_tail(x[:, r0:r1].contiguous(), a[:, r0:r1].contiguous(), *weights, *_nhwc_halo(x, r0, r1))
             for r0, r1 in bands(16, CUTS[cut])]
    close(torch.cat(parts, 1), whole)
    want = np.asarray(dfc_tail_from_x(*(jnp.asarray(t) for t in args), interpret=True))
    np.testing.assert_allclose(torch.cat(parts, 1).numpy(), want, atol=1e-4, rtol=1e-4)


def test_halo_rows_must_be_a_row_of_x():
    x = torch.zeros(2, 4, 6, 3)
    with pytest.raises(ValueError, match="top has shape"):
        conv3x3_bn_relu(x, torch.zeros(3, 3, 3, 8), torch.zeros(8), top=torch.zeros(2, 5, 3))
