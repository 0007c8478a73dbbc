"""The pooled attention's epilogue (ops/lsa_epilogue.py): the upsample of the p x p attention output,
gamma and the residual add in one pass.

On the CPU the plain version is held to the serving engine's former torch expression bit for bit,
at the flagship's level shapes (p = 8) and where the map is already p x p, and a band of rows to the
rows of the whole image's result.  Marked ``card`` (skipped without an NVIDIA card): the CUDA kernel
against the plain version in bf16 and f32 within one ulp of the dtype (the kernel spells out the
roundings and FMAs of torch's upsample kernels, so in practice the two are the same bits); the
wrapper's refusals; nine launches a forward of the engine.  On the card, from
the root of the repository (this file imports no JAX, the test configuration does):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lsa_epilogue.py -m card
"""

import pytest
import torch

from dfc_sa_unet_torch.infer.engine import DFCEngine, _conv
from dfc_sa_unet_torch.models.blocks import nchw, nhwc
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.ops import launches, reset_launches
from dfc_sa_unet_torch.ops.lsa_epilogue import lsa_epilogue, lsa_epilogue_plain
from dfc_sa_unet_torch.ops.pooled_attention import pooled_attention
from dfc_sa_unet_torch.ops.pooling import adaptive_avg_pool
from dfc_sa_unet_torch.ops.resize import resize_bilinear
from dfc_sa_unet_torch.utils.weights import init_random_

torch.set_num_threads(2)
POOL = 8
# (H, W, C) of the flagship's levels at 224x224 (the decoder's repeat the encoder's), then a level
# already p x p (the resize is the identity), an odd size, and a map larger than the level
SHAPES = [(224, 224, 64), (112, 112, 128), (56, 56, 256), (28, 28, 512), (14, 14, 1024),
          (8, 8, 64), (13, 17, 24), (5, 6, 16)]
DTYPES = [torch.bfloat16, torch.float32]


def _inputs(b, h, w, c, dtype, p=POOL, seed=0, device="cpu"):
    """a (post-ReLU, as the attention branch's input), o and a gamma away from its initial 0."""
    g = torch.Generator(device=device).manual_seed(seed)
    a = torch.relu(torch.randn(b, h, w, c, generator=g, device=device)).to(dtype)
    o = torch.randn(b, p, p, c, generator=g, device=device).to(dtype)
    return a, o, torch.tensor([0.37], dtype=torch.float32, device=device)


def _former(a, o, gamma):
    """The engine's expression before the kernel (infer/engine.py::_lsa): NCHW views of the NHWC
    tensors, torch's resize, the f32 island."""
    h, w = a.shape[1:3]
    up = resize_bilinear(nchw(o), (h, w))
    return nhwc((gamma * up.float() + nchw(a).float()).to(a.dtype))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
@pytest.mark.parametrize("h,w,c", SHAPES)
def test_plain_is_the_former_expression_bit_for_bit(h, w, c, dtype):
    a, o, gamma = _inputs(2, h, w, c, dtype)
    got = lsa_epilogue_plain(a, o, gamma)
    assert got.dtype == dtype and got.shape == a.shape and got.is_contiguous()
    assert torch.equal(got, _former(a, o, gamma))


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
@pytest.mark.parametrize("h,w,c,bands", [(56, 56, 32, 4), (28, 20, 16, 2), (14, 14, 24, 7), (8, 8, 16, 2)])
def test_band_rows_are_the_whole_images_rows(h, w, c, bands, dtype):
    a, o, gamma = _inputs(2, h, w, c, dtype, seed=1)
    whole = lsa_epilogue_plain(a, o, gamma)
    rows = h // bands
    for row0 in range(0, h, rows):
        got = lsa_epilogue(a[:, row0:row0 + rows].contiguous(), o, gamma, height=h, row0=row0)
        assert torch.equal(got, whole[:, row0:row0 + rows]), row0


def test_cpu_tensors_take_the_plain_version():
    a, o, gamma = _inputs(2, 14, 14, 32, torch.bfloat16)
    reset_launches()
    assert torch.equal(lsa_epilogue(a, o, gamma), lsa_epilogue_plain(a, o, gamma))
    assert launches()["lsa_epilogue"] == 0


def test_other_devices_never_fall_back():
    """A tensor off the CPU and off a card (here the meta device) raises; the plain version runs
    only when all three lie on the CPU."""
    a, o, gamma = _inputs(2, 14, 14, 32, torch.bfloat16)
    for args in ((a.to("meta"), o, gamma), (a, o.to("meta"), gamma), (a, o, gamma.to("meta"))):
        with pytest.raises(ValueError, match="lsa_epilogue"):
            lsa_epilogue(*args)


@pytest.mark.parametrize("height,row0", [(14, 1), (13, 0), (28, 15), (28, -1)])
def test_a_band_outside_the_image_raises(height, row0):
    a, o, gamma = _inputs(1, 14, 14, 8, torch.float32)
    with pytest.raises(ValueError, match="do not lie"):
        lsa_epilogue(a, o, gamma, height=height, row0=row0)


def test_engine_lsa_is_the_former_chain():
    """DFCEngine._lsa on the CPU: the attention of the engine's own q, k, v convs, then the former
    expression, bit for bit (bf16, as served)."""
    cfg = {"model": {"name": "DFC-SA-Res-Block", "features": [8, 16, 24, 32], "pool_size": 4}}
    model = init_random_(create_model(cfg, device="cpu"), torch.Generator().manual_seed(3)).eval()
    eng = DFCEngine(cfg, model, dtype=torch.bfloat16, device="cpu")
    d = eng.blocks["down2"]["lsa"]
    d["gamma"] = torch.full_like(d["gamma"], 0.6)
    x = torch.relu(torch.randn(2, 16, 20, 12)).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        got = eng._lsa(d, x)
        pooled = adaptive_avg_pool(x, (4, 4))
        q, k, v = (nhwc(_conv(pooled, *d[key])) for key in ("query", "key", "value"))
        want = nchw(_former(nhwc(x), pooled_attention(q, k, v), d["gamma"]))
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, want)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _ordered(t):
    """Floats as integers in the order of their values (sign and magnitude to two's complement)."""
    bits = t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).to(torch.int64)
    mag = bits & (0x7FFF if t.dtype == torch.bfloat16 else 0x7FFFFFFF)
    return torch.where(bits < 0, -mag, mag)


def _ulps(got, want):
    return int((_ordered(got) - _ordered(want)).abs().max().item())


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
@pytest.mark.parametrize("b,h,w,c,p", [(128, 224, 224, 64, 8), (128, 112, 112, 128, 8), (128, 56, 56, 256, 8),
                                       (128, 28, 28, 512, 8), (128, 14, 14, 1024, 8), (1, 224, 224, 64, 8),
                                       (1, 14, 14, 1024, 8), (3, 13, 17, 24, 8), (2, 8, 8, 64, 8),
                                       (2, 9, 7, 12, 4), (2, 21, 33, 3, 8)])
def test_kernel_matches_plain(card, b, h, w, c, p, dtype):
    a, o, gamma = _inputs(b, h, w, c, dtype, p=p, seed=b + h + c, device=card)
    reset_launches()
    got = lsa_epilogue(a, o, gamma)
    want = lsa_epilogue_plain(a, o, gamma)
    torch.cuda.synchronize()
    assert launches()["lsa_epilogue"] == 1
    assert got.shape == want.shape and got.dtype == dtype
    assert _ulps(got, want) <= 1


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_kernel_band_rows(card, dtype):
    """A band's rows (height, row0) against the whole image's plain result."""
    a, o, gamma = _inputs(4, 56, 56, 256, dtype, seed=5, device=card)
    whole = lsa_epilogue_plain(a, o, gamma)
    for row0 in (0, 14, 28, 42):
        got = lsa_epilogue(a[:, row0:row0 + 14].contiguous(), o, gamma, height=56, row0=row0)
        assert _ulps(got, whole[:, row0:row0 + 14]) <= 1, row0


@pytest.mark.card
def test_wrapper_refuses(card):
    a, o, gamma = _inputs(2, 14, 14, 64, torch.bfloat16, device=card)
    with pytest.raises(TypeError):
        lsa_epilogue(a.half(), o.half(), gamma)
    with pytest.raises(TypeError):
        lsa_epilogue(a, o.float(), gamma)
    with pytest.raises(TypeError):
        lsa_epilogue(a, o, gamma.double())
    with pytest.raises(ValueError):
        lsa_epilogue(a, o.cpu(), gamma)
    with pytest.raises(ValueError):
        lsa_epilogue(nchw(a), o, gamma)  # an NCHW view: not NHWC-contiguous
    with pytest.raises(ValueError):
        lsa_epilogue(a, o[..., :32].contiguous(), gamma)


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d).split(".")[-1])
def test_engine_forward_launches_nine(card, dtype):
    cfg = {"model": {"name": "DFC-SA-Res-Block", "features": [64, 128, 256, 512], "pool_size": 8}}
    model = init_random_(create_model(cfg, device="cpu"), torch.Generator().manual_seed(0))
    eng = DFCEngine(cfg, model, dtype=dtype, device=card, tail_kernel_levels="auto", conv_kernel_levels="auto")
    x = torch.randn(2, 3, 64, 64, device=card).contiguous(memory_format=torch.channels_last)
    reset_launches()
    with torch.inference_mode():
        eng(x)
    torch.cuda.synchronize()
    assert launches()["lsa_epilogue"] == 9
