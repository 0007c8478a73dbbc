"""The f32 bias of a product added in place (ops/bias_add.py, csrc/bias_add.cu).

On the CPU: the plain version is torch's ``y.add_(bias)`` and the f32 sum rounded once, bit for
bit, returning y itself, in bf16 and f32 at Dense-shaped and conv-shaped inputs; the layout the
kernel takes for each kind of input (dtype, any C, channels_last and NCHW-contiguous maps, one-value
and 0-dim biases, views that are not dense or not aligned, a CPU tensor); ``add_bias_`` under
autograd (its forward value and f32 bias gradient); and a kernel layout for every biased layer of a
SegFormer-B5, a TransUNet and a DFC-SA flagship forward (370, 74 and 64 calls), the shapes that
scripts/bench_torch_bias_add.py times.  Marked ``card`` (skipped without an NVIDIA card): the
kernel against ``y.clone().add_(bias)`` with ``torch.equal`` at every bias shape of SegFormer-B5 at
1024x1024 (B=16), TransUNet and the flagship module at 224x224 (B=128), in bf16 and f32, at C = 8,
at widths and planes no vector divides, at row counts no block divides and on an unaligned view, in
place; the inputs it refuses raise; and the launch counts of one served request of each cell's
model.  On the card, from the root of the repository (this
file imports no JAX, the test configuration does):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_bias_add.py -m card
"""

from collections import Counter

import numpy as np
import pytest
import torch

from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.nn import layers
from dfc_sa_unet_torch.ops import launches, reset_launches
from dfc_sa_unet_torch.ops.bias_add import bias_add, bias_add_plain, kernel_layout
from scripts import bench_torch_bias_add as bias_bench

torch.set_num_threads(2)
DTYPES = [torch.bfloat16, torch.float32]
CL = torch.channels_last
SEGFORMER = {"model": {"name": "SegFormer"}}  # B5 with the 768-wide head, the factory's defaults
TRANSUNET = {"model": {"name": "TransformerUNet", "in_channels": 3, "out_channels": 1,
                       "resnet_num_layers": [3, 4, 9], "hidden_size": 768, "num_layers": 12, "num_heads": 12,
                       "mlp_dim": 3072, "patches_grid": [14, 14], "decoder_channels": [256, 128, 64, 16],
                       "n_skip": 3},
             "dataset": {"img_size": [224, 224]}}
FLAGSHIP = {"model": {"name": "DFC-SA-Res-Block", "features": [64, 128, 256, 512], "pool_size": 8}}


def _dtype_id(d):
    return str(d).split(".")[-1]


def _product(shape, dtype, layout=None, seed=0, device="cpu"):
    """A product-like y of ``shape`` (NCHW shapes stored as ``layout``) and its f32 bias along dim 1
    of a 4-D y, else along the last."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = (torch.randn(shape, generator=g, device=device) * 3).to(dtype)
    if layout is not None:
        y = y.contiguous(memory_format=layout)
    c = shape[1] if len(shape) == 4 else shape[-1]
    bias = torch.randn(c, generator=g, device=device)
    return y, (bias.view(-1, 1, 1) if len(shape) == 4 else bias)


# ---------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("shape,layout", [((2, 50, 64), None), ((3, 7, 3072), None), ((5, 12), None),
                                          ((2, 64, 9, 11), CL), ((2, 16, 8, 8), torch.contiguous_format),
                                          ((2, 1, 16, 16), CL)],
                         ids=["dense", "dense3072", "dense_c12", "conv_cl", "conv_nchw", "conv_c1"])
def test_plain_is_the_former_add_bit_for_bit(shape, layout, dtype):
    y, bias = _product(shape, dtype, layout)
    former = y.clone(memory_format=torch.preserve_format).add_(bias)
    once = (y.float() + bias).to(dtype)
    strides, ptr = y.stride(), y.data_ptr()
    got = bias_add_plain(y, bias)
    assert got is y and got.data_ptr() == ptr and got.stride() == strides
    assert torch.equal(got, former) and torch.equal(got, once)


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
def test_cpu_tensors_take_the_plain_version(dtype):
    y, bias = _product((4, 33, 128), dtype)
    want = y.clone().add_(bias)
    reset_launches()
    got = bias_add(y, bias)
    counts = launches()
    assert got is y and torch.equal(got, want)
    assert counts["bias_add"] == 0


def _aligned_bf16(n, offset):
    """A bf16 tensor of n elements starting ``offset`` elements into a fresh (aligned) buffer."""
    return torch.zeros(n + offset, dtype=torch.bfloat16)[offset:]


# (label, y, bias, the layout the kernel takes): (C, inner), or None where the card raises
LAYOUT_CASES = [
    ("dense_bf16", torch.zeros(4, 10, 64, dtype=torch.bfloat16), torch.zeros(64), (64, 1)),
    ("dense_f32", torch.zeros(4, 10, 12), torch.zeros(12), (12, 1)),
    ("dense_bf16_c8", torch.zeros(3, 8, dtype=torch.bfloat16), torch.zeros(8), (8, 1)),
    ("dense_bf16_c12", torch.zeros(4, 10, 12, dtype=torch.bfloat16), torch.zeros(12), (12, 1)),
    ("dense_f32_c6", torch.zeros(4, 6), torch.zeros(6), (6, 1)),
    ("dense_f16", torch.zeros(4, 64, dtype=torch.float16), torch.zeros(64), None),
    ("dense_bf16_bias", torch.zeros(4, 64, dtype=torch.bfloat16), torch.zeros(64, dtype=torch.bfloat16), None),
    ("dense_f64_bias", torch.zeros(4, 64), torch.zeros(64, dtype=torch.float64), None),
    ("bias_strided", torch.zeros(4, 64, dtype=torch.bfloat16), torch.zeros(128)[::2], (64, 1)),
    ("bias_0dim", torch.zeros(4, 64, dtype=torch.bfloat16), torch.tensor(0.5), None),
    ("bias_0dim_f32", torch.zeros(4, 64), torch.tensor(0.5), None),
    ("bias_two_dims", torch.zeros(2, 4, 64, dtype=torch.bfloat16), torch.zeros(4, 64), None),
    ("bias_longer_than_y", torch.zeros(64, dtype=torch.bfloat16), torch.zeros(1, 64), None),
    ("y_transposed", torch.zeros(64, 4, dtype=torch.bfloat16).t(), torch.zeros(64), None),
    ("y_strided", torch.zeros(4, 128, dtype=torch.bfloat16)[:, ::2], torch.zeros(64), None),
    ("y_expanded", torch.zeros(1, 64, dtype=torch.bfloat16).expand(4, 64), torch.zeros(64), None),
    ("y_unaligned", _aligned_bf16(4 * 64, 1).view(4, 64), torch.zeros(64), (64, 1)),
    ("y_empty", torch.zeros(0, 64, dtype=torch.bfloat16), torch.zeros(64), (64, 1)),
    ("conv_cl", torch.zeros(2, 64, 5, 7, dtype=torch.bfloat16).contiguous(memory_format=CL),
     torch.zeros(64, 1, 1), (64, 1)),
    ("conv_cl_c12", torch.zeros(2, 12, 8, 8, dtype=torch.bfloat16).contiguous(memory_format=CL),
     torch.zeros(12, 1, 1), (12, 1)),
    ("conv_nchw", torch.zeros(2, 16, 8, 8, dtype=torch.bfloat16), torch.zeros(16, 1, 1), (16, 64)),
    ("conv_nchw_f32", torch.zeros(2, 3, 2, 6), torch.zeros(3, 1, 1), (3, 12)),
    ("conv_nchw_hw25", torch.zeros(2, 16, 5, 5, dtype=torch.bfloat16), torch.zeros(16, 1, 1), (16, 25)),
    ("conv_one_pixel", torch.zeros(2, 64, 1, 1, dtype=torch.bfloat16), torch.zeros(64, 1, 1), (64, 1)),
    ("conv_c1", torch.zeros(2, 1, 16, 16, dtype=torch.bfloat16).contiguous(memory_format=CL),
     torch.zeros(1, 1, 1), (1, 512)),
    ("conv_c1_odd", torch.zeros(1, 1, 3, 5, dtype=torch.bfloat16), torch.zeros(1, 1, 1), (1, 15)),
    ("conv_permuted", torch.zeros(2, 8, 8, 16, dtype=torch.bfloat16).permute(0, 3, 2, 1),
     torch.zeros(16, 1, 1), None),
    ("conv_bias_on_w", torch.zeros(2, 4, 8, 16, dtype=torch.bfloat16).contiguous(memory_format=CL),
     torch.zeros(16), None),
]


@pytest.mark.parametrize("y,bias,want", [c[1:] for c in LAYOUT_CASES], ids=[c[0] for c in LAYOUT_CASES])
def test_dispatch_layout(y, bias, want):
    assert kernel_layout(y, bias) == want


@pytest.mark.parametrize("y,bias,want", [c[1:] for c in LAYOUT_CASES if c[3] is not None],
                         ids=[c[0] for c in LAYOUT_CASES if c[3] is not None])
def test_layout_names_the_bias_of_every_element(y, bias, want):
    """Element i of y in memory takes bias[(i // inner) % C]: the kernel's indexing gives torch's
    broadcast."""
    c, inner = want
    y = torch.zeros_like(y, dtype=torch.float32, memory_format=torch.preserve_format)
    b = torch.arange(bias.numel(), dtype=torch.float32).view(bias.shape)
    y.add_(b)
    flat = y.as_strided((y.numel(),), (1,))  # y's elements in memory order (y is dense)
    assert torch.equal(flat, (torch.arange(y.numel()) // inner % c).float())


def test_a_bf16_product_with_a_bf16_layer_falls_back():
    """A bf16 bias is not the kernel's: torch's add_ on the CPU, ValueError on the card (every layer
    of the port keeps its bias in f32)."""
    y, bias = _product((2, 5, 64), torch.bfloat16)
    assert kernel_layout(y, bias.bfloat16()) is None


@pytest.mark.parametrize("shape,layout", [((2, 6, 24), None), ((2, 16, 5, 6), CL),
                                          ((2, 16, 4, 6), torch.contiguous_format), ((2, 1, 4, 6), CL)],
                         ids=["dense", "conv_cl", "conv_nchw", "conv_c1"])
def test_add_bias_under_autograd_is_unchanged(shape, layout):
    """``add_bias_`` on a product that requires grad (``_AddBias``, through ``ops.bias_add``): the
    value is the f32 sum rounded once and the bias gradient the f32 sum of the output's gradient."""
    y0, bias = _product(shape, torch.bfloat16, layout, seed=3)
    w = torch.randn(shape, generator=torch.Generator().manual_seed(4))
    x = y0.float().requires_grad_(True)
    b = bias.clone().requires_grad_(True)
    y = x.to(torch.bfloat16)  # a fresh non-leaf product in y0's layout
    got = layers.add_bias_(y, b)
    assert got is y and got.requires_grad
    (got.float() * w).sum().backward()
    xr = y0.float().requires_grad_(True)
    br = bias.clone().requires_grad_(True)
    want = (xr.to(torch.bfloat16) + br).to(torch.bfloat16)
    (want.float() * w).sum().backward()
    assert torch.equal(got.detach(), want.detach())
    assert b.grad.dtype == torch.float32 and b.grad.shape == bias.shape
    np.testing.assert_allclose(b.grad.numpy(), br.grad.numpy(), rtol=1e-6, atol=1e-5)
    assert torch.equal(x.grad, xr.grad)


def test_add_bias_takes_bias_add_with_and_without_autograd(monkeypatch):
    """Both of ``add_bias_``'s paths go through ``ops.bias_add``: the autograd Function's forward and
    the plain call."""
    seen = []

    def spy(y, bias):
        seen.append(torch.is_grad_enabled())
        return bias_add(y, bias)

    monkeypatch.setattr(layers, "bias_add", spy)
    dense = layers.Dense(8, 16, compute_dtype=torch.bfloat16)
    x = torch.randn(2, 8)
    dense(x).float().sum().backward()
    with torch.no_grad():
        dense(x)
    with torch.inference_mode():
        dense(x)
    assert seen == [False, False, False]  # the Function's forward runs with grad off


def test_launch_counters_are_registered_and_reset():
    from dfc_sa_unet_torch.ops import bias_add as mod

    mod.LAUNCHES["bias_add"] += 3
    assert launches()["bias_add"] >= 3
    reset_launches()
    assert launches()["bias_add"] == 0


def _layouts_of_a_forward(monkeypatch, cfg, x):
    """The kernel layout of every ``add_bias_`` call of one bf16 forward of ``cfg``'s model."""
    found = []

    def spy(y, bias):
        found.append((tuple(y.shape), kernel_layout(y, bias)))
        return bias_add(y, bias)

    monkeypatch.setattr(layers, "bias_add", spy)
    model = create_model(cfg, dtype=torch.bfloat16, device="cpu").eval()
    with torch.inference_mode():
        model(x.contiguous(memory_format=CL))
    return found


def _timed_shapes(model, **sizes):
    """{y shape: launches} of scripts/bench_torch_bias_add.py's table for ``model``."""
    counts = Counter()
    for _, shape, _, count in bias_bench.MODELS[model](**sizes):
        counts[shape] += count
    return dict(counts)


def test_every_segformer_bias_takes_the_kernel_layout(monkeypatch):
    """SegFormer-B5 at published widths (a 128x128 tile): 52 blocks x (q, kv, proj, fc1, the depthwise
    conv, fc2), 49 reduction convs, 4 patch embeddings, 4 ``linear_c`` and ``linear_pred`` (C = 1):
    370 biased outputs a forward, each in a layout the kernel takes, at the shapes the bench times."""
    found = _layouts_of_a_forward(monkeypatch, SEGFORMER, torch.randn(1, 3, 128, 128))
    assert len(found) == 370
    assert [s for s, layout in found if layout is None] == []
    assert found[-1] == ((1, 1, 32, 32), (1, 32 * 32))  # linear_pred's logits, one plane
    assert dict(Counter(s for s, _ in found)) == _timed_shapes("segformer", batch=1, side=128)


def test_every_transunet_bias_takes_the_kernel_layout(monkeypatch):
    """TransUNet R50-ViT-B/16 at 224x224: 12 layers x 6 ``Dense``, the patch embedding and the C = 1
    segmentation head: 74 biased outputs a forward, each in a layout the kernel takes, at the shapes
    the bench times."""
    found = _layouts_of_a_forward(monkeypatch, TRANSUNET, torch.randn(1, 3, 224, 224))
    assert len(found) == 74
    assert [s for s, layout in found if layout is None] == []
    assert found[-1] == ((1, 1, 224, 224), (1, 224 * 224))
    assert dict(Counter(s for s, _ in found)) == _timed_shapes("transunet", batch=1)


def test_every_flagship_bias_takes_the_kernel_layout(monkeypatch):
    """The DFC-SA flagship module at 224x224 (its engine adds its biases itself): 64 biased conv
    outputs a forward, each in a layout the kernel takes, at the shapes the bench times."""
    found = _layouts_of_a_forward(monkeypatch, FLAGSHIP, torch.randn(1, 3, 224, 224))
    assert len(found) == 64
    assert [s for s, layout in found if layout is None] == []
    assert dict(Counter(s for s, _ in found)) == _timed_shapes("flagship", batch=1)


def _smoke_configs():
    """{factory name: (model config, image side)} of every model whose counts chip_smoke.py holds."""
    import chip_smoke

    cfgs = {chip_smoke.CONFIG["model"]["name"]: (chip_smoke.CONFIG, 64)}
    cfgs.update({cfg["model"]["name"]: (cfg, 224) for cfg, _ in chip_smoke.ZOO.values()})
    cfgs.update({name: (chip_smoke.model_config(name), 64) for name in chip_smoke.DFC_ZOO})
    return cfgs, chip_smoke.BIAS_LAUNCHES


@pytest.mark.parametrize("name", sorted(_smoke_configs()[1]))
def test_chip_smoke_bias_counts_are_a_forwards_calls(monkeypatch, name):
    """chip_smoke.py's ``BIAS_LAUNCHES``, which its phases hold the card's launches to: one call of the
    bias pass for every biased layer of a forward, counted here on the CPU, and the model's every
    biased output in a layout the kernel takes."""
    cfgs, counts = _smoke_configs()
    cfg, side = cfgs[name]
    found = _layouts_of_a_forward(monkeypatch, cfg, torch.randn(1, 3, side, side))
    assert len(found) == counts[name]
    assert [s for s, layout in found if layout is None] == []


@pytest.mark.parametrize("model,launches_a_request", [("segformer", 370), ("transunet", 74), ("flagship", 64)])
def test_timed_shapes_are_a_requests_launches(model, launches_a_request):
    """scripts/bench_torch_bias_add.py (chip_smoke.py's phase 7) times a request's biased outputs:
    as many launches as a forward makes, each shape in a layout the kernel takes."""
    shapes = bias_bench.MODELS[model]()
    assert sum(count for *_, count in shapes) == launches_a_request
    for label, shape, layout, _ in shapes:
        y = torch.empty((1,) + shape[1:], dtype=torch.bfloat16)  # one image of the request
        y = y if layout is None else y.contiguous(memory_format=layout)
        c = shape[1] if len(shape) == 4 else shape[-1]
        bias = torch.empty(c).view(-1, 1, 1) if len(shape) == 4 else torch.empty(c)
        assert kernel_layout(y, bias) is not None, (label, shape)


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


# {label: (y shape, layout)}: every biased output shape of a request of SegFormer-B5, TransUNet and the
# flagship module (the bench's tables), then widths and planes no 16-byte vector divides and row counts no
# block divides
CARD_SHAPES = {**{f"{model}_{label}": (shape, layout) for model in sorted(bias_bench.MODELS)
                  for label, shape, layout, _ in bias_bench.MODELS[model]()},
               "c8": ((3, 5, 8), None), "ragged_rows": ((1, 1000003, 64), None),
               "ragged_rows_wide": ((7, 1031, 1280), None), "nchw_conv": ((3, 64, 33, 40), torch.contiguous_format),
               "nchw_conv_c320": ((2, 320, 32, 32), torch.contiguous_format), "cl_conv_odd": ((3, 40, 17, 23), CL),
               "dense_c12": ((4, 33, 12), None), "dense_c6": ((5, 7, 6), None), "cl_conv_c12": ((2, 12, 7, 9), CL),
               "nchw_hw25": ((2, 16, 5, 5), torch.contiguous_format), "c1_odd": ((1, 1, 3, 5), None),
               "dense_c3_long": ((1, 100003, 3), None)}


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("label", sorted(CARD_SHAPES))
def test_kernel_is_torch_add_bit_for_bit(card, label, dtype):
    shape, layout = CARD_SHAPES[label]
    y, bias = _product(shape, dtype, layout, seed=len(label), device=card)
    want = y.clone(memory_format=torch.preserve_format).add_(bias)
    ptr, strides = y.data_ptr(), y.stride()
    assert kernel_layout(y, bias) is not None
    reset_launches()
    got = bias_add(y, bias)
    torch.cuda.synchronize()
    assert launches()["bias_add"] == 1
    assert got is y and y.data_ptr() == ptr and y.stride() == strides
    assert torch.equal(got, want)


@pytest.mark.card
def test_kernel_leaves_the_neighbours_alone(card):
    """A slice of a buffer (aligned, so the kernel takes it) is written and its neighbours are not."""
    buf = torch.randn(4 * 96 + 64, device=card).to(torch.bfloat16)
    before = buf.clone()
    y = buf[32:32 + 4 * 96].view(4, 96)
    bias = torch.randn(96, device=card)
    want = y.clone().add_(bias)
    reset_launches()
    bias_add(y, bias)
    torch.cuda.synchronize()
    assert launches()["bias_add"] == 1
    assert torch.equal(y, want)
    assert torch.equal(buf[:32], before[:32]) and torch.equal(buf[32 + 4 * 96:], before[32 + 4 * 96:])


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("offset", [1, 3])
def test_kernel_takes_an_unaligned_view(card, offset, dtype):
    """A view that starts inside a 16-byte vector takes the scalar path: the same bits, in place."""
    buf = torch.randn(offset + 5 * 64, device=card).to(dtype)
    y = buf[offset:].view(5, 64)
    bias = torch.randn(64, device=card)
    want = y.clone().add_(bias)
    reset_launches()
    bias_add(y, bias)
    torch.cuda.synchronize()
    assert launches()["bias_add"] == 1
    assert torch.equal(y, want)


@pytest.mark.card
def test_kernel_refusals_raise(card):
    """What the kernel does not take raises on the card, launches nothing and leaves y as it was."""
    y, bias = _product((4, 64), torch.bfloat16, device=card)
    cases = {"f16": (y.half(), bias), "bf16_bias": (y, bias.bfloat16()), "0dim_bias": (y, bias[0]),
             "strided": (torch.zeros(4, 128, dtype=torch.bfloat16, device=card)[:, ::2], bias),
             "transposed": (torch.zeros(64, 4, dtype=torch.bfloat16, device=card).t(), bias),
             "cpu_bias": (y, bias.cpu())}
    for label, (yy, bb) in cases.items():
        before = yy.clone()
        reset_launches()
        with pytest.raises(ValueError, match="bias_add"):
            bias_add(yy, bb)
        assert launches()["bias_add"] == 0, label
        assert torch.equal(yy, before), label


@pytest.mark.card
@pytest.mark.parametrize("shape,layout", [((2, 50, 768), None), ((2, 64, 16, 16), CL), ((2, 1, 16, 16), CL)],
                         ids=["dense", "conv_cl", "conv_c1"])
def test_add_bias_under_autograd_on_the_card(card, shape, layout):
    """``_AddBias`` through the kernel: the value bit for bit and the bias gradient as torch's."""
    y0, bias = _product(shape, torch.bfloat16, layout, seed=9, device=card)
    w = torch.randn(shape, device=card)
    grads, values = [], []
    for kernel in (True, False):
        x = y0.float().requires_grad_(True)
        b = bias.clone().requires_grad_(True)
        y = x.to(torch.bfloat16)
        reset_launches()
        out = layers.add_bias_(y, b) if kernel else (y + b).to(torch.bfloat16)
        (out.float() * w).sum().backward()
        if kernel:
            assert launches()["bias_add"] == 1
        grads.append(b.grad)
        values.append(out.detach())
    assert torch.equal(values[0], values[1])
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-5, atol=1e-3)


def _served_counts(cfg, batch, side, card):
    """The bias pass's counts of one request of ``batch`` uint8 side x side tiles through the
    Predictor, bf16, as the cells serve them."""
    from dfc_sa_unet_torch.infer.predictor import Predictor

    model = create_model(cfg, dtype=torch.bfloat16, device=card)
    pred = Predictor(model, compute_dtype=torch.bfloat16, device=card)
    tiles = np.random.default_rng(0).integers(0, 256, size=(batch, side, side, 3), dtype=np.uint8)
    pred.predict_probs(tiles[:1])  # the first call's set-up is not the request
    reset_launches()
    pred.predict_probs(tiles)
    torch.cuda.synchronize()
    return launches()["bias_add"]


@pytest.mark.card
def test_segformer_request_launches_370(card):
    assert _served_counts(SEGFORMER, 16, 1024, card) == 370


@pytest.mark.card
def test_transunet_request_launches_74(card):
    assert _served_counts(TRANSUNET, 128, 224, card) == 74


@pytest.mark.card
def test_flagship_module_request_launches_64(card):
    assert _served_counts(FLAGSHIP, 128, 224, card) == 64


@pytest.mark.card
def test_flagship_engine_never_adds_through_it(card):
    from dfc_sa_unet_torch.infer.engine import DFCEngine
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.utils.weights import init_random_

    model = init_random_(create_model(FLAGSHIP, device="cpu"), torch.Generator().manual_seed(0))
    eng = DFCEngine(FLAGSHIP, model, dtype=torch.bfloat16, device=card, tail_kernel_levels="auto",
                    conv_kernel_levels="auto")
    pred = Predictor(eng, compute_dtype=torch.bfloat16, device=card)
    tiles = np.random.default_rng(1).integers(0, 256, size=(128, 224, 224, 3), dtype=np.uint8)
    reset_launches()
    pred.predict_probs(tiles)
    torch.cuda.synchronize()
    counts = launches()
    assert counts["bias_add"] == 0
    assert counts["lsa_epilogue"] == 9  # the engine did serve
