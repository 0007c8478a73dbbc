"""The band ops that row (spatial) sharding added for the families after the DFC family, in one
process with no group: a whole tensor is cut into equal bands, each band is handed its
neighbours' rows from the whole tensor (``rows.exchange_rows`` replaced by a slice of it, ``fill``
past the image's edges), and the stitched band outputs are held against the op on the whole tensor.
The collectives are the 2- and 4-process tests' part (tests/test_torch_rows_families*.py).

The layers as the models call them: TransUNet's 7x7/2 root, a bottleneck's 3x3/2 and 1x1/2 convs
(weight-standardised), a 16x16/16 patch conv, ViT-seg's ConvTranspose(4, 2, 1), the 3x3/2 max pool
at padding 1 (one row above, -inf), GroupNorm (its statistics over bands of different means, each
band in a thread, its sums over the group every band's), the bilinear resize by global coordinates
(align_corners True 2x, False up and down); the s8 3x3 conv's plain version with its halo rows (bit
for bit, at cuts of a band of one row), and the plain pooled attention with a band's queries
against every key, against the band's rows of the JAX package's ``fused_pooled_attention`` on the
whole image (Pallas interpret mode).  f32 within 1e-5 of max|reference| (the convs of a band and of
the whole image may sum in other orders), exact where the op is.
"""

import threading
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dfc_sa_unet_tpu.ops.pallas_attention import fused_pooled_attention
from dfc_sa_unet_torch.nn.layers import Conv, ConvTranspose, GroupNorm, WSConv
from dfc_sa_unet_torch.ops.attention import pooled_self_attention
from dfc_sa_unet_torch.ops.conv_s8 import conv3x3_s8, pack_s8_taps
from dfc_sa_unet_torch.ops.pooling import max_pool
from dfc_sa_unet_torch.ops.resize import resize_bilinear
from dfc_sa_unet_torch.parallel import rows

torch.set_num_threads(2)


def close(got, want, rel=1e-5):
    want = torch.as_tensor(want).double()
    err = (torch.as_tensor(got).double() - want).abs().max().item()
    assert err <= rel * max(want.abs().max().item(), 1e-30), err


def banded(monkeypatch, op, x, count):
    """op over ``count`` equal bands of NCHW x, each in its band's context with its neighbours' rows
    sliced from x, stitched along the rows."""
    h = x.shape[2]

    def exchange(t, band=None, above=1, below=1, fill=0.0):
        band = band or rows.current()
        scale = h // t.shape[2] // band.count  # t is a band of x's rows at x's resolution
        assert scale == 1, "the test's ops exchange rows of their input"
        r0, r1 = band.row0, band.row0 + band.rows
        pad = torch.full((x.shape[0], x.shape[1], max(above, below), x.shape[3]), fill, dtype=x.dtype)
        whole = torch.cat([pad, x, pad], 2)
        off = pad.shape[2]
        return whole[:, :, off + r0 - above:off + r0], whole[:, :, off + r1:off + r1 + below]

    monkeypatch.setattr(rows, "exchange_rows", exchange)
    outs = []
    for s in range(count):
        band = rows.band_of(s, count, h)
        with rows.band_context(band):
            outs.append(op(x[:, :, band.row0:band.row0 + band.rows]))
    return torch.cat(outs, 2)


def _randn(*shape, seed=0, scale=1.0, shift=0.0):
    return torch.from_numpy(np.random.default_rng(seed).normal(shift, scale, shape).astype(np.float32))


LAYERS = {
    "7x7/2 root, padding 3 (3 rows above, 2 below)": lambda: WSConv(3, 8, 7, stride=2, padding=3),
    "3x3/2, padding 1 (1 above, none below)": lambda: WSConv(8, 8, 3, stride=2, padding=1),
    "1x1/2 projection": lambda: WSConv(8, 16, 1, stride=2),
    "16x16/16 patches (no halo)": lambda: Conv(8, 16, 16, stride=16),
    "ConvTranspose(4, 2, 1) (1 each side)": lambda: ConvTranspose(8, 4, kernel_size=4, stride=2, padding=1),
}


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("layer", LAYERS)
def test_windowed_layers_over_bands_are_the_whole_image_layer(monkeypatch, layer, count):
    torch.manual_seed(0)
    net = LAYERS[layer]()
    x = _randn(2, net.in_channels, 64, 24, seed=1).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = net(x)
        got = banded(monkeypatch, net, x, count)
    assert got.shape == want.shape
    close(got, want)


@pytest.mark.parametrize("count", [2, 4])
def test_strided_max_pool_reads_one_row_above_filled_with_minus_inf(monkeypatch, count):
    x = _randn(2, 4, 32, 20, seed=2) - 5.0  # all negative: a zero fill would show
    got = banded(monkeypatch, lambda t: max_pool(t, 3, 2, padding=1), x, count)
    assert torch.equal(got, F.max_pool2d(x, 3, 2, 1))


@pytest.mark.parametrize("count", [2, 4])
def test_group_norm_takes_the_whole_image_statistics_in_two_passes(count):
    """Bands of different means and spreads, each in a thread of its own whose ``all_reduce_sum`` is
    the sum of every band's partial sums: a GroupNorm on the band's own statistics fails.  Means of
    300 and more against spreads of 1-2: one-pass E[x^2] - E[x]^2 in f32 would miss by far more
    than 1e-5."""
    gn = GroupNorm(4, 16, eps=1e-6)
    with torch.no_grad():
        gn.weight.copy_(torch.linspace(0.5, 1.5, 16))
        gn.bias.copy_(torch.linspace(-1, 1, 16))
    x = torch.cat([_randn(2, 16, 8, 12, seed=3 + s, scale=1.0 + s / 4, shift=300.0 + 5.0 * s) for s in range(count)], 2)
    barrier = threading.Barrier(count, timeout=60)
    partial = {}

    def group_sum(t, group=None):
        partial[rows.current().index] = t
        barrier.wait()
        total = sum(partial[s] for s in range(count))
        barrier.wait()  # every band has read the sums before the next call overwrites them
        return total

    outs, errors = [None] * count, []

    def run(s):
        try:
            band = rows.band_of(s, count, x.shape[2])
            with torch.no_grad(), rows.band_context(band):
                outs[s] = gn(x[:, :, band.row0:band.row0 + band.rows])
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            barrier.abort()

    with mock.patch.object(rows, "all_reduce_sum", group_sum):
        threads = [threading.Thread(target=run, args=(s,)) for s in range(count)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise errors[0]
    want = F.group_norm(x.double(), 4, gn.weight.double(), gn.bias.double(), 1e-6)
    close(torch.cat(outs, 2), want)


RESIZES = {"align_corners 2x up": (8, 16, True), "2x up": (8, 16, False), "2x down": (32, 16, False),
           "4x up": (4, 16, False)}


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("resize", RESIZES)
def test_band_resize_is_the_band_rows_of_the_whole_resize(monkeypatch, resize, count):
    h_in, h_out, corners = RESIZES[resize]
    x = _randn(2, 3, h_in, 6, seed=4)
    size = (h_out // count, 10)  # the band's rows of the output, the width
    got = banded(monkeypatch, lambda t: resize_bilinear(t, size, align_corners=corners), x, count)
    want = F.interpolate(x, size=(h_out, 10), mode="bilinear", align_corners=corners)
    close(got, want, 1e-6)


@pytest.mark.parametrize("cuts", [[8, 8], [4, 4, 4, 4], [1, 5, 10]])
def test_s8_conv_plain_version_with_halo_rows_stitches_bit_for_bit(cuts):
    """Cin 24, zero-padded to 32 with the halo rows; f32 and bf16 out."""
    g = torch.Generator().manual_seed(5)
    x8 = torch.randint(-127, 128, (2, 16, 9, 24), dtype=torch.int8, generator=g)
    w8 = pack_s8_taps(torch.randint(-127, 128, (16, 24, 3, 3), dtype=torch.int8, generator=g))
    scale, b = torch.rand(16, generator=g) * 1e-3, torch.randn(16, generator=g)
    for out_dtype in (torch.float32, torch.bfloat16):
        whole = conv3x3_s8(x8, w8, scale, b, out_dtype)
        parts, r0 = [], 0
        for n in cuts:
            top = x8[:, r0 - 1] if r0 > 0 else None
            bottom = x8[:, r0 + n] if r0 + n < 16 else None
            parts.append(conv3x3_s8(x8[:, r0:r0 + n].contiguous(), w8, scale, b, out_dtype, top=top, bottom=bottom))
            r0 += n
        assert torch.equal(torch.cat(parts, 1), whole)
        assert whole.float().std() > 0


@pytest.mark.parametrize("count", [2, 4])
def test_pooled_attention_with_fewer_queries_than_keys_is_the_band_rows_of_the_jax_kernel(count):
    """The full-resolution attention of a 16x16 map (N = 256, C' 4, C 32) under a band: the band's
    queries against every key, against the JAX kernel on the whole map."""
    rng = np.random.default_rng(6)
    q, k = (rng.normal(0, 1, (2, 16, 16, 4)).astype(np.float32) for _ in range(2))
    v = rng.normal(0, 1, (2, 16, 16, 32)).astype(np.float32)
    want = np.asarray(fused_pooled_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    h = 16 // count
    for s in range(count):
        got = pooled_self_attention(torch.from_numpy(q[:, s * h:(s + 1) * h]), torch.from_numpy(k),
                                    torch.from_numpy(v))
        assert got.shape == (2, h, 16, 32)
        close(got, want[:, s * h:(s + 1) * h])
