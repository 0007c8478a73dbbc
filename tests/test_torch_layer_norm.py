"""LayerNorm over the last dimension (nn/layers.py::LayerNorm, ops/layer_norm.py, csrc/layer_norm.cu).

On the CPU: the plain version is the layer's former forward bit for bit (x cast to f32, torch's
layer_norm, the cast back) at every width the port's models normalise, both eps, bf16 and f32; the
layer on the CPU gives exactly that and launches nothing; under autograd with a tensor requiring
grad it keeps torch's ops (its value and gradients as before, no launch) even where the tensors
look like a card's, and without autograd it launches the kernel once; the kernel's lane plan
(``lanes``) for every width the three models use and the widths it refuses; the wrapper's
refusals through the seam (ops/_build.py), with the tensors shown to it as a card's; the launches
of one forward of SegFormer-B5 (161), TransUNet (25), ViT-seg (24) and the flagship (none), each
at a shape the kernel takes, and the shapes scripts/bench_torch_layer_norm.py times; and
chip_smoke.py's ``LN_LAUNCHES``.  Marked ``card`` (skipped without an NVIDIA card): the kernel
against the plain version at every LayerNorm shape of the three models at their cells' batch, in
bf16 (within one ulp, ``bench_torch_layer_norm.ulps``, at most 1% of elements differing, no further
from an f64 LayerNorm than the plain version plus one ulp) and f32 (chip_smoke.py's TOL), after a
launch on a NaN-filled output;
widths and row counts no group divides; the refusals; and the launches of served requests.  On the
card, from the root of the repository (this file imports no JAX, the test configuration does):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_layer_norm.py -m card
"""

import os
import sys
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dfc_sa_unet_torch.models.factory import create_model  # noqa: E402
from dfc_sa_unet_torch.nn import layers  # noqa: E402
from dfc_sa_unet_torch.ops import _build, launches, reset_launches  # noqa: E402
from dfc_sa_unet_torch.ops.layer_norm import MAX_VECTORS, layer_norm, layer_norm_plain, lanes  # noqa: E402
from scripts import bench_torch_layer_norm as ln_bench  # noqa: E402

torch.set_num_threads(2)
BF, F32 = torch.bfloat16, torch.float32
DTYPES = [BF, F32]
WIDTHS = [64, 128, 320, 512, 768]  # SegFormer-B5's four stages, TransUNet's and ViT-seg's hidden size
SEGFORMER = {"model": {"name": "SegFormer"}}  # B5 with the 768-wide head, the factory's defaults
TRANSUNET = {"model": {"name": "TransformerUNet", "in_channels": 3, "out_channels": 1,
                       "resnet_num_layers": [3, 4, 9], "hidden_size": 768, "num_layers": 12, "num_heads": 12,
                       "mlp_dim": 3072, "patches_grid": [14, 14], "decoder_channels": [256, 128, 64, 16],
                       "n_skip": 3},
             "dataset": {"img_size": [224, 224]}}
VIT_SEG = {"model": {"name": "VisionTransformerSegmentation", "in_channels": 3, "out_channels": 1, "img_dim": 224,
                     "patch_dim": 16, "embed_dim": 768, "num_layers": 12, "num_heads": 12, "mlp_dim": 3072,
                     "dropout": 0.1}}
FLAGSHIP = {"model": {"name": "DFC-SA-Res-Block", "features": [64, 128, 256, 512], "pool_size": 8}}


def _dtype_id(d):
    return str(d).split(".")[-1]


def _operands(shape, dtype, seed=0, device="cpu"):
    """Token-like x (rows of their own mean and spread) and an f32 weight and bias."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows = tuple(shape[:-1]) + (1,)
    x = (torch.randn(shape, generator=g, device=device) * (0.5 + 3 * torch.rand(rows, generator=g, device=device))
         + 2 * torch.randn(rows, generator=g, device=device)).to(dtype)
    c = shape[-1]
    return (x, 1 + 0.2 * torch.randn(c, generator=g, device=device),
            0.2 * torch.randn(c, generator=g, device=device))


def _former(x, weight, bias, eps):
    """The layer's forward before the kernel."""
    return F.layer_norm(x.float(), (x.shape[-1],), weight, bias, eps).to(x.dtype)


@pytest.fixture
def as_card(monkeypatch):
    """The seam shown the CPU tensors as a card's (``on_cpu`` false, every tensor on cuda:0 to
    ``check_operands``) with its kernel lookup replaced by a recorder: every launch is recorded as
    (entry point, arguments) and returns no error."""
    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(torch.Tensor, "device", property(lambda t: torch.device("cuda", 0)))
    monkeypatch.setattr(_build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(_build, "kernel", lambda entry: lambda *args: calls.append((entry, args)) or 0)
    reset_launches()
    yield calls
    reset_launches()


# ---------------------------------------------------------------- on the CPU


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("c", WIDTHS)
def test_plain_is_the_former_forward_bit_for_bit(c, eps, dtype):
    x, w, b = _operands((2, 9, c), dtype, seed=c)
    got = layer_norm_plain(x, w, b, eps)
    assert got.dtype == dtype and torch.equal(got, _former(x, w, b, eps))


@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference"])
def test_layer_on_the_cpu_is_the_former_forward(mode, dtype):
    """The layer on CPU tensors, with and without autograd: the former values, no launch."""
    ln = layers.LayerNorm(320, eps=1e-6)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(320, generator=torch.Generator().manual_seed(1)))
        ln.bias.copy_(0.1 * torch.randn(320, generator=torch.Generator().manual_seed(2)))
    x, _, _ = _operands((3, 7, 320), dtype, seed=3)
    context = {"grad": torch.enable_grad, "no_grad": torch.no_grad, "inference": torch.inference_mode}[mode]
    reset_launches()
    with context():
        got = ln(x)
    assert launches()["layer_norm"] == 0
    assert torch.equal(got.detach(), _former(x, ln.weight.detach(), ln.bias.detach(), 1e-6))


@pytest.mark.parametrize("needs", ["weight", "x"])
def test_under_autograd_torch_ops_run_and_nothing_launches(as_card, needs):
    """On what the seam takes for a card, a forward whose graph autograd needs (the parameters
    requiring grad, or x alone with them frozen) runs torch's ops: the former values and gradients,
    and no launch."""
    ln = layers.LayerNorm(128, eps=1e-5)
    with torch.no_grad():
        ln.weight.copy_(1 + 0.1 * torch.randn(128, generator=torch.Generator().manual_seed(4)))
    ln.requires_grad_(needs == "weight")
    x0, _, _ = _operands((2, 11, 128), BF, seed=5)
    up = torch.randn(2, 11, 128, generator=torch.Generator().manual_seed(6))
    grads = []
    for forward in (ln, lambda t: _former(t, ln.weight, ln.bias, ln.eps)):
        x = x0.clone().requires_grad_(needs == "x")
        out = forward(x)
        (out.float() * up).sum().backward()
        grads.append([out.detach(), *(t.grad for t in (x, ln.weight, ln.bias))])
        ln.zero_grad(set_to_none=True)
    assert as_card == [] and launches()["layer_norm"] == 0
    for got, want in zip(*grads):
        assert (got is None) == (want is None)
        assert got is None or torch.equal(got, want)
    assert (grads[0][2] is not None) == (needs == "weight") and (grads[0][1] is not None) == (needs == "x")


@pytest.mark.parametrize("mode", ["no_grad", "inference"])
def test_without_autograd_the_layer_launches_the_kernel_once(as_card, mode):
    """Served (no_grad or inference mode), the layer on what the seam takes for a card launches the
    kernel once: x, weight, bias, y, the rows, C, the lane plan, eps as a float and the stream."""
    ln = layers.LayerNorm(64, eps=1e-6)
    x, _, _ = _operands((4, 96, 64), BF)
    context = {"no_grad": torch.no_grad, "inference": torch.inference_mode}[mode]
    with context():
        y = ln(x)
    assert [entry for entry, _ in as_card] == ["layer_norm_bf16"]
    args = as_card[0][1]
    assert args[:3] == (x.data_ptr(), ln.weight.data_ptr(), ln.bias.data_ptr())
    assert args[3] == y.data_ptr() and args[3] != x.data_ptr()
    assert args[4:] == (4 * 96, 64, 8, 1, 1e-6, 0) and isinstance(args[8], float)  # the stream last
    assert y.shape == x.shape and y.dtype == BF and y.is_contiguous()
    assert launches()["layer_norm"] == 1


# (C, dtype, (G, V)): every width of the three models, then a group's last lanes a vector short, the widest
# rows, and None where the kernel refuses (no 16-byte vector divides the row, wider than 32 lanes hold, f16)
LANE_CASES = [(64, BF, (8, 1)), (128, BF, (8, 2)), (320, BF, (8, 5)), (512, BF, (8, 8)), (768, BF, (16, 6)),
              (64, F32, (8, 2)), (128, F32, (8, 4)), (320, F32, (16, 5)), (512, F32, (16, 8)), (768, F32, (32, 6)),
              (96, BF, (8, 2)), (100, F32, (8, 4)), (8, BF, (8, 1)), (2048, BF, (32, 8)), (1024, F32, (32, 8)),
              (100, BF, None), (6, F32, None), (12, BF, None), (4096, BF, None), (2048, F32, None), (0, BF, None),
              (64, torch.float16, None)]


@pytest.mark.parametrize("c,dtype,want", LANE_CASES, ids=[f"{c}_{_dtype_id(d)}" for c, d, _ in LANE_CASES])
def test_lanes(c, dtype, want):
    assert lanes(c, dtype) == want
    if want is not None:  # the group holds the row, and no smaller group would
        g, v = want
        per = 16 // dtype.itemsize
        assert v <= MAX_VECTORS and (v - 1) * g < c // per <= v * g
        assert g == 8 or -(-(c // per) // (g // 2)) > MAX_VECTORS


@pytest.mark.parametrize("c,dtype", [(c, d) for c, d, want in LANE_CASES if want is None and d in DTYPES],
                         ids=[f"{c}_{_dtype_id(d)}" for c, d, want in LANE_CASES if want is None and d in DTYPES])
def test_a_width_the_kernel_refuses_raises_on_the_card_path(as_card, c, dtype):
    x, w, b = _operands((3, 5, c), dtype)
    with torch.no_grad(), pytest.raises(ValueError, match="layer_norm"):
        layer_norm(x, w, b, 1e-5)
    assert as_card == [] and launches()["layer_norm"] == 0


def _refusals():
    x, w, b = _operands((4, 6, 64), BF)
    buf = torch.zeros(4 * 6 * 64 + 8, dtype=BF)
    return {
        "f16": ((x.half(), w, b), TypeError),
        "weight_bf16": ((x, w.bfloat16(), b), TypeError),
        "bias_f64": ((x, w, b.double()), TypeError),
        "transposed": ((x.transpose(0, 1), w, b), ValueError),
        "strided": ((torch.zeros(4, 6, 128, dtype=BF)[..., ::2], w, b), ValueError),
        "unaligned": ((buf[1:1 + 4 * 6 * 64].view(4, 6, 64), w, b), ValueError),
        "weight_short": ((x, w[:32].contiguous(), b), ValueError),
        "bias_long": ((x, w, torch.zeros(128)), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_refusals_through_the_seam(as_card, case):
    """What the kernel does not take raises through ``_build.check_operands`` or the wrapper's own
    checks, and launches nothing."""
    (x, w, b), error = _refusals()[case]
    with torch.no_grad(), pytest.raises(error, match="layer_norm"):
        layer_norm(x, w, b, 1e-6)
    assert as_card == [] and launches()["layer_norm"] == 0


def test_the_wrapper_under_grad_raises(as_card):
    """The kernel has no backward: called with grad enabled on a tensor that requires it, the wrapper
    raises (the layer takes torch's ops before it gets there)."""
    x, w, b = _operands((2, 3, 64), BF)
    with pytest.raises(NotImplementedError, match="layer_norm"):
        layer_norm(x, w.requires_grad_(True), b, 1e-6)
    assert as_card == []


def _norms_of_a_forward(monkeypatch, cfg, x):
    """[(x shape, eps, the lane plan)] of every LayerNorm's call of one bf16 forward of ``cfg``'s model."""
    found = []

    def spy(t, weight, bias, eps):
        found.append((tuple(t.shape), eps, lanes(t.shape[-1], t.dtype) if t.is_contiguous() else None))
        return layer_norm(t, weight, bias, eps)

    monkeypatch.setattr(layers, "layer_norm", spy)
    model = create_model(cfg, dtype=BF, device="cpu").eval()
    with torch.inference_mode():
        model(x.contiguous(memory_format=torch.channels_last))
    return found


def _timed(model, **sizes):
    """{(x shape, eps): launches} of scripts/bench_torch_layer_norm.py's table for ``model``."""
    counts = Counter()
    for _, shape, eps, count in ln_bench.MODELS[model](**sizes):
        counts[(shape, eps)] += count
    return dict(counts)


def test_every_segformer_norm_takes_the_kernel(monkeypatch):
    """SegFormer-B5 at published widths (a 128x128 tile): 4 patch embeddings' norms, 52 blocks x 2, 49
    reduction norms and 4 stage norms, 161 a forward, each contiguous at a width the kernel takes, at
    the shapes and eps the bench times."""
    found = _norms_of_a_forward(monkeypatch, SEGFORMER, torch.randn(1, 3, 128, 128))
    assert len(found) == 161
    assert [s for s, _, plan in found if plan is None] == []
    assert dict(Counter((s, eps) for s, eps, _ in found)) == _timed("segformer", batch=1, side=128)


@pytest.mark.parametrize("cfg,model,count", [(TRANSUNET, "transunet", 25), (VIT_SEG, "vit_seg", 24)],
                         ids=["transunet", "vit_seg"])
def test_every_transformer_norm_takes_the_kernel(monkeypatch, cfg, model, count):
    """TransUNet (12 pre-norm layers x 2 and the encoder's norm, eps 1e-6) and ViT-seg (12 post-norm
    layers x 2, eps 1e-5) at 224x224: each norm contiguous at 768 wide, at the bench's shapes."""
    found = _norms_of_a_forward(monkeypatch, cfg, torch.randn(1, 3, 224, 224))
    assert len(found) == count
    assert [s for s, _, plan in found if plan is None] == []
    assert dict(Counter((s, eps) for s, eps, _ in found)) == _timed(model, batch=1)


def _smoke_configs():
    """{factory name: (model config, image side)} of every model whose counts chip_smoke.py holds."""
    import chip_smoke

    cfgs = {chip_smoke.CONFIG["model"]["name"]: (chip_smoke.CONFIG, 64), "SegFormer": (SEGFORMER, 64)}
    cfgs.update({cfg["model"]["name"]: (cfg, 224) for cfg, _ in chip_smoke.ZOO.values()})
    cfgs.update({name: (chip_smoke.model_config(name), 64) for name in chip_smoke.DFC_ZOO})
    return cfgs, chip_smoke.LN_LAUNCHES


def test_chip_smoke_counts_every_model():
    cfgs, counts = _smoke_configs()
    assert set(counts) == set(cfgs)


@pytest.mark.parametrize("name", sorted(_smoke_configs()[1]))
def test_chip_smoke_ln_counts_are_a_forwards_calls(monkeypatch, name):
    """chip_smoke.py's ``LN_LAUNCHES``, which its phases hold the card's launches to: one launch for
    every LayerNorm of a forward, counted here on the CPU, each at a width the kernel takes."""
    cfgs, counts = _smoke_configs()
    cfg, side = cfgs[name]
    found = _norms_of_a_forward(monkeypatch, cfg, torch.randn(1, 3, side, side))
    assert len(found) == counts[name]
    assert [s for s, _, plan in found if plan is None] == []


@pytest.mark.parametrize("model,request_launches", [("segformer", 161), ("transunet", 25), ("vit_seg", 24)])
def test_timed_shapes_are_a_requests_launches(model, request_launches):
    """scripts/bench_torch_layer_norm.py (and chip_smoke.py's phase 7) times a request's norms: as many
    launches as a forward makes, each at a width the kernel takes in bf16 and f32."""
    shapes = ln_bench.MODELS[model]()
    assert sum(count for *_, count in shapes) == request_launches
    for label, shape, _, _ in shapes:
        assert lanes(shape[-1], BF) and lanes(shape[-1], F32), label


@pytest.mark.parametrize("at,value,want", [(1, 3.015625, 1.0), (5, 8.0625, 1.0), (0, 1.5, 64.0), (3, -1e-6, 0.0082),
                                            (4, 2 ** -12, 1.0)], ids=["one", "one_at_8", "many", "sign", "at_floor"])
def test_ulps_counts_bf16_spacings_with_a_floor_near_zero(at, value, want):
    """The bench's distance: |got - want| over bf16's spacing at each element of want, the spacing taken
    at no less than 2^-8 of max|want| (here 2^-5, spacing 2^-12), so that two values near zero on
    either side of it lie a small part of a spacing apart."""
    ref = torch.tensor([1.0, 3.0, -0.5, 1e-6, 0.0, 8.0]).bfloat16()
    got = ref.clone()
    got[at] = value
    assert ln_bench.ulps(got, ref) == pytest.approx(want, rel=0.01)
    assert ln_bench.ulps(ref, ref) == 0.0


def test_segformer_request_bound_is_3_6_ms():
    """The bound the kernel is held to: a SegFormer-B5 request's 3.019e9 elements read and written once
    in bf16 at 3.35 TB/s."""
    rows = ln_bench.segformer_shapes()
    elements = sum(np.prod(shape) * count for _, shape, _, count in rows)
    assert abs(elements - 3.019e9) < 1e6
    bound = sum((4 * np.prod(shape) + 8 * shape[-1]) * count for _, shape, _, count in rows) / ln_bench.HBM_BYTES_PER_S
    assert 3.60e-3 < bound < 3.61e-3


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


# {label: (x shape, eps)}: every LayerNorm shape of a request of SegFormer-B5 (B=16, 1024x1024), TransUNet and
# ViT-seg (B=128), then widths whose groups are a vector short, the widest rows and row counts no step divides
CARD_SHAPES = {**{f"{model}_{label}": (shape, eps) for model in sorted(ln_bench.MODELS)
                  for label, shape, eps, _ in ln_bench.MODELS[model]()},
               "c96": ((3, 7, 96), 1e-5), "c104": ((3, 7, 104), 1e-5), "c8": ((5, 8), 1e-6),
               "c1024": ((2, 33, 1024), 1e-6), "one_row": ((1, 64), 1e-6), "ragged_rows": ((1, 100003, 64), 1e-6),
               "ragged_rows_320": ((3, 1001, 320), 1e-5)}


@pytest.mark.card
@pytest.mark.parametrize("dtype", DTYPES, ids=_dtype_id)
@pytest.mark.parametrize("label", sorted(CARD_SHAPES))
def test_kernel_meets_the_gates(card, label, dtype):
    shape, eps = CARD_SHAPES[label]
    gen = torch.Generator(device=card).manual_seed(len(label))
    with torch.inference_mode():
        x, w, b = ln_bench.inputs(shape, gen, dtype)
        reset_launches()
        got = ln_bench.check(x, w, b, eps)
        torch.cuda.synchronize()
    assert launches()["layer_norm"] == 1
    assert got["ok"], got


@pytest.mark.card
def test_empty_rows_launch_nothing(card):
    x = torch.zeros(0, 64, dtype=BF, device=card)
    reset_launches()
    with torch.inference_mode():
        y = layer_norm(x, torch.ones(64, device=card), torch.zeros(64, device=card), 1e-6)
    assert y.shape == (0, 64) and launches()["layer_norm"] == 0


@pytest.mark.card
def test_kernel_refusals_raise(card):
    x, w, b = _operands((4, 6, 64), BF, device=card)
    buf = torch.zeros(4 * 6 * 64 + 8, dtype=BF, device=card)
    cases = {"f16": (x.half(), w, b, TypeError), "weight_bf16": (x, w.bfloat16(), b, TypeError),
             "transposed": (x.transpose(0, 1), w, b, ValueError),
             "unaligned": (buf[1:1 + 4 * 6 * 64].view(4, 6, 64), w, b, ValueError),
             "weight_short": (x, w[:32].contiguous(), b, ValueError), "weight_cpu": (x, w.cpu(), b, ValueError),
             "c100": (torch.zeros(4, 100, dtype=BF, device=card), torch.ones(100, device=card),
                      torch.zeros(100, device=card), ValueError)}
    for label, (xx, ww, bb, error) in cases.items():
        reset_launches()
        with torch.no_grad(), pytest.raises(error, match="layer_norm"):
            layer_norm(xx, ww, bb, 1e-6)
        assert launches()["layer_norm"] == 0, label


@pytest.mark.card
def test_layer_under_autograd_on_the_card(card):
    """Training on the card keeps torch's ops: the former value and gradients, no launch."""
    ln = layers.LayerNorm(768, eps=1e-6).to(card)
    x0, _, _ = _operands((4, 196, 768), BF, seed=7, device=card)
    x = x0.clone().requires_grad_(True)
    reset_launches()
    out = ln(x)
    out.float().sum().backward()
    assert launches()["layer_norm"] == 0
    xr = x0.clone().requires_grad_(True)
    want = _former(xr, ln.weight, ln.bias, 1e-6)
    assert torch.equal(out, want)


def _served_counts(cfg, batch, side, card):
    """The kernel's launches in one request of ``batch`` uint8 side x side tiles through the Predictor,
    bf16, as the cells serve them."""
    from dfc_sa_unet_torch.infer.predictor import Predictor

    model = create_model(cfg, dtype=BF, device=card)
    pred = Predictor(model, compute_dtype=BF, device=card)
    tiles = np.random.default_rng(0).integers(0, 256, size=(batch, side, side, 3), dtype=np.uint8)
    pred.predict_probs(tiles[:1])  # the first call's set-up is not the request
    reset_launches()
    pred.predict_probs(tiles)
    torch.cuda.synchronize()
    return launches()["layer_norm"]


@pytest.mark.card
def test_segformer_request_launches_161(card):
    assert _served_counts(SEGFORMER, 16, 1024, card) == 161


@pytest.mark.card
def test_transunet_request_launches_25(card):
    assert _served_counts(TRANSUNET, 128, 224, card) == 25


@pytest.mark.card
def test_flagship_engine_launches_none(card):
    from dfc_sa_unet_torch.infer.engine import DFCEngine
    from dfc_sa_unet_torch.infer.predictor import Predictor
    from dfc_sa_unet_torch.utils.weights import init_random_

    model = init_random_(create_model(FLAGSHIP, device="cpu"), torch.Generator().manual_seed(0))
    eng = DFCEngine(FLAGSHIP, model, dtype=BF, device=card, tail_kernel_levels="auto", conv_kernel_levels="auto")
    pred = Predictor(eng, compute_dtype=BF, device=card)
    tiles = np.random.default_rng(1).integers(0, 256, size=(128, 224, 224, 3), dtype=np.uint8)
    reset_launches()
    pred.predict_probs(tiles)
    torch.cuda.synchronize()
    counts = launches()
    assert counts["layer_norm"] == 0 and counts["lsa_epilogue"] == 9  # the engine did serve
