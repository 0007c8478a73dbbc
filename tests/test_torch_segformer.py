"""SegFormer (models/segformer.py) against its plain float32 reference
(portbench/reference/segformer_b5_city1024.py), and the pooled-attention wrapper's cases that it
brings: more queries than keys, and heads side by side in each row, k and v the two halves of one
projection.

On the CPU, at a tiny width (dims 16/32/40/64, depths 1/1/2/1, the published heads and ratios) and
seeded weights, in f32: the module against the reference at square and non-square tiles (atol 2e-5:
the same sums in another order, the q scale folded into its layer), the published state-dict keys
and shapes at full width on the meta device, the factory's name, the Predictor at a tile that is not
square, and the wrapper's plain path.  Marked ``card`` (skipped without an NVIDIA card): the kernel
at SegFormer-B5's four launch shapes at 1024x1024, bf16 and f32, against the plain version; a query
row the same bits whatever part of the rows a call takes; the whole model's 52 launches.  On the
card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_segformer.py -m card
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dfc_sa_unet_torch.infer.predictor import Predictor  # noqa: E402
from dfc_sa_unet_torch.models.factory import create_model  # noqa: E402
from dfc_sa_unet_torch.models.segformer import B5, SegFormer  # noqa: E402
from dfc_sa_unet_torch.ops import launches, reset_launches  # noqa: E402
from dfc_sa_unet_torch.ops.pooled_attention import pooled_attention, tma_rows  # noqa: E402
from portbench.reference import segformer_b5_city1024 as reference  # noqa: E402
from portbench.reference.plain import normalize  # noqa: E402
from portbench.weights import seeded_state  # noqa: E402

torch.set_num_threads(2)
TINY = {"name": "SegFormer", "in_channels": 3, "out_channels": 1, "embed_dims": [16, 32, 40, 64],
        "depths": [1, 1, 2, 1], "num_heads": [1, 2, 5, 8], "sr_ratios": [8, 4, 2, 1], "mlp_ratio": 4,
        "decoder_dim": 32}


def _tiny(seed=5, device="cpu", dtype=None):
    """(port module in eval mode, the reference's seeded state dict) at the tiny width."""
    cfg = {"model": TINY}
    sd = seeded_state(reference.state_spec(cfg), seed, device)
    model = create_model(cfg, dtype=dtype, device=device).eval()
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return model, sd


@pytest.mark.parametrize("hw", [(64, 64), (96, 64)], ids=["64x64", "96x64"])
def test_module_matches_the_reference(hw):
    model, sd = _tiny()
    x = torch.randn(2, 3, *hw, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x.contiguous(memory_format=torch.channels_last))
        want = reference.Model({"model": TINY}, sd)(x)
    assert got.shape == want.shape == (2, 1, *hw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


def test_module_in_bf16_stays_within_rounding():
    """bf16 compute with f32 parameters: the logits' mean gap to the f32 reference is a few hundredths
    of their spread, as far as the reference moves when its own products' operands are rounded.
    oneDNN is off: its CPU bf16 convolution at kernel 8, stride 8 returns a wrong result on some maps
    (16x24 of 16 channels: a mean error of the output's spread, torch 2.13), which the card's cuDNN
    never runs."""
    model, sd = _tiny(dtype=torch.bfloat16)
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(2))
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        got = model(x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)).float()
        want = reference.Model({"model": TINY}, sd)(x)
        rounded = reference.Model({"model": TINY}, sd, precision="bf16")(x)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    spread = want.std()
    gap, rounding = (got - want).abs().mean() / spread, (rounded - want).abs().mean() / spread
    assert gap < 0.05 and gap < 5 * rounding, (gap, rounding)


def test_published_keys_and_shapes_at_full_width():
    """The NVlabs code's keys and shapes: the module's state dict is the reference's spec, key for
    key, with 84,594,113 parameters (the configuration file's count)."""
    cfg = {"model": {"name": "SegFormer"}}
    model = create_model(cfg, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items() if not k.endswith("num_batches_tracked")}
    want = {k: tuple(shape) for k, (shape, _) in reference.state_spec(cfg).items()}
    assert got == want
    assert sum(p.numel() for p in model.parameters()) == 84_594_113
    for key, shape in [("backbone.patch_embed1.proj.weight", (64, 3, 7, 7)),
                       ("backbone.patch_embed4.norm.weight", (512,)),
                       ("backbone.block1.2.attn.sr.weight", (64, 64, 8, 8)),
                       ("backbone.block3.39.attn.kv.weight", (640, 320)),
                       ("backbone.block3.39.mlp.dwconv.dwconv.weight", (1280, 1, 3, 3)),
                       ("backbone.norm3.bias", (320,)),
                       ("decode_head.linear_c4.proj.weight", (768, 512)),
                       ("decode_head.linear_fuse.conv.weight", (768, 3072, 1, 1)),
                       ("decode_head.linear_fuse.bn.running_var", (768,)),
                       ("decode_head.linear_pred.bias", (1,))]:
        assert got[key] == shape, key
    assert not any(k.startswith("backbone.block4.") and ".attn.sr." in k for k in got)  # ratio 1: no reduction
    assert model.backbone.block1[0].norm1.eps == 1e-6 and model.backbone.patch_embed1.norm.eps == 1e-5
    assert model.backbone.block1[0].attn.norm.eps == 1e-5 and model.backbone.norm4.eps == 1e-6


def test_factory_name_and_widths():
    model = create_model({"model": {"name": "SegFormer", "out_channels": 3}}, device="meta")
    assert isinstance(model, SegFormer) and model.num_classes == 3
    assert [len(getattr(model.backbone, f"block{i}")) for i in range(1, 5)] == list(B5["depths"])
    assert model.backbone.block3[0].attn.q.scale == 0.125
    tiny = create_model({"model": TINY}, device="meta")
    assert [len(getattr(tiny.backbone, f"block{i}")) for i in range(1, 5)] == TINY["depths"]
    assert [getattr(tiny.backbone, f"block{i}")[0].attn.num_heads for i in range(1, 5)] == TINY["num_heads"]


def test_predictor_serves_a_tile_that_is_not_square():
    """The Predictor's path (uint8 in, normalise, forward, sigmoid) at 96x64, against the reference's
    probabilities; a sliding tile must be a multiple of 32."""
    model, sd = _tiny()
    pred = Predictor(model, device="cpu")
    images = torch.randint(0, 256, (2, 96, 64, 3), generator=torch.Generator().manual_seed(3), dtype=torch.uint8)
    got = pred.predict_probs(images.numpy())
    with torch.no_grad():
        want = torch.sigmoid(reference.Model({"model": TINY}, sd)(normalize(images)))[:, 0]
    assert got.shape == (2, 96, 64)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)
    canvas = pred.predict_sliding(images[0].numpy(), tile_size=64, overlap=32)
    assert canvas.shape == (96, 64) and np.isfinite(canvas).all()
    with pytest.raises(ValueError, match="multiple of 32"):
        pred.predict_sliding(images[0].numpy(), tile_size=48, overlap=0)


def test_inference_cli_serves_it_from_its_yaml(tmp_path, capsys):
    """``python -m dfc_sa_unet_torch.inference`` with the shipped YAML (its widths cut to the tiny ones,
    everything else as shipped: bf16 from its ``inference`` section), on the CPU: the factory, the
    Predictor's sliding windows and the module path, with the artifacts and metrics written."""
    import yaml

    from dfc_sa_unet_torch import inference
    from dfc_sa_unet_torch.data.synthetic import generate

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = yaml.safe_load(open(os.path.join(root, "dfc_sa_unet_torch", "configs", "config_segformer_b5.yaml")))
    assert {k: cfg["model"][k] for k in B5} == {k: list(v) if isinstance(v, tuple) else v for k, v in B5.items()}
    assert cfg["model"]["name"] == "SegFormer" and cfg["inference"]["bf16"] is True
    cfg["model"].update({k: v for k, v in TINY.items() if k != "name"})
    cfg_path = tmp_path / "segformer.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    model, _ = _tiny()
    torch.save(model.state_dict(), tmp_path / "w.pth")
    data = generate(str(tmp_path / "data"), n=2, size=96, seed=4)
    with torch.backends.mkldnn.flags(enabled=False):  # oneDNN's bf16 conv at kernel 8 (see above)
        inference.main(inference.parse_args(["--config", str(cfg_path), "--model", str(tmp_path / "w.pth"),
                                             "--input", data, "--output", str(tmp_path / "out"), "--tile_size",
                                             "64", "--overlap", "32", "--batch_size", "4", "--device", "cpu"]))
    out = capsys.readouterr().out
    assert "bfloat16" in out and "Micro-Averaged" in out
    assert (tmp_path / "out" / "evaluation_metrics.csv").exists()


def test_row_sharding_raises():
    from dfc_sa_unet_torch.parallel import rows

    model, _ = _tiny()
    band = rows.Band(index=0, count=2, height=64, row0=0, prev=None, next=1)
    with rows.band_context(band), pytest.raises(NotImplementedError, match="SegFormer"):
        model(torch.zeros(1, 3, 32, 64))


def _heads_softmax(q, k, v, heads):
    """softmax(q k^T) v of each head, written out."""
    b, nq, _ = q.shape
    out = []
    for h in range(heads):
        qh, kh, vh = (t.unflatten(-1, (heads, -1))[..., h, :].double() for t in (q, k, v))
        out.append(torch.softmax(qh @ kh.transpose(1, 2), dim=-1) @ vh)
    return torch.cat(out, -1).float()


@pytest.mark.parametrize("nq,nk,heads,ch", [(256, 16, 1, 16), (96, 24, 5, 8), (64, 64, 8, 8), (300, 4, 2, 16)])
def test_wrapper_takes_more_queries_than_keys_and_heads_on_the_plain_path(nq, nk, heads, ch):
    """[B,N,heads C'] tokens, k and v the two halves of one [B,M,2 heads C] projection (views whose
    rows lie twice their width apart): every head's softmax(q k^T) v, on the plain path, launching
    nothing; a map [B,h,w,heads C'] of queries gives the same in its shape."""
    g = torch.Generator().manual_seed(nq + nk)
    q = torch.randn(2, nq, heads * ch, generator=g)
    kv = torch.randn(2, nk, 2 * heads * ch, generator=g)
    k, v = kv[..., :heads * ch], kv[..., heads * ch:]
    reset_launches()
    got = pooled_attention(q, k, v, heads)
    assert got.shape == (2, nq, heads * ch)
    np.testing.assert_allclose(got.numpy(), _heads_softmax(q, k, v, heads).numpy(), atol=2e-6)
    got_map = pooled_attention(q.view(2, nq // 4, 4, -1), k.unflatten(1, (nk, 1)), v.unflatten(1, (nk, 1)), heads)
    assert torch.equal(got_map.reshape(got.shape), got)
    counts = launches()
    assert counts["pooled_attention"] == 0 and counts["pooled_attention.more_queries"] == 0


def test_tma_rows_reads_a_projections_halves_where_they_lie():
    """k and v as halves of one bf16 [B,M,2 heads 64] projection are read as they are (rows 16-byte
    multiples apart, each head 64 channels); a head of 12 channels is padded per head to 16."""
    kv = torch.zeros(2, 16, 2 * 5 * 64, dtype=torch.bfloat16)
    for half in (kv[..., :320], kv[..., 320:]):
        assert tma_rows(half, 5) is half
    t = torch.randn(2, 7, 3 * 12).to(torch.bfloat16)
    padded = tma_rows(t, 3)
    assert padded.shape == (2, 7, 3 * 16) and padded.is_contiguous()
    assert torch.equal(padded.unflatten(-1, (3, 16))[..., :12], t.unflatten(-1, (3, 12)))
    assert not padded.unflatten(-1, (3, 16))[..., 12:].any()


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _stage_inputs(stage, b, dtype, device, seed=0):
    """q [B,nq,heads 64] (times 1/8, as the model's folded scale leaves it) and k, v the halves of one
    kv projection, at SegFormer-B5's stage ``stage`` (1..4) of a 1024x1024 tile."""
    side = 1024 >> (1 + stage)
    sr, heads = B5["sr_ratios"][stage - 1], B5["num_heads"][stage - 1]
    nq, nk, e = side * side, (side // sr) ** 2, 64 * heads
    g = torch.Generator(device=device).manual_seed(seed)
    q = (torch.randn(b, nq, e, generator=g, device=device) * 0.125).to(dtype)
    kv = torch.randn(b, nk, 2 * e, generator=g, device=device).to(dtype)
    return q, kv[..., :e], kv[..., e:], heads


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("stage", [1, 2, 3, 4])
def test_kernel_at_the_launch_shapes(card, stage, dtype):
    """B=2 at each stage's launch shape (65536, 16384, 4096, 1024 queries against 1024 keys; 1, 2, 5, 8
    heads of 64): bf16 within 2e-2 of the plain version's largest output (chip_smoke.py's allowance; the
    outputs, means of v over 1024 keys, stay well below 1, so the limit is a few bf16 roundings of it),
    f32 within 2e-5 of it; one launch, counted among those with more queries than keys where it has
    them."""
    from dfc_sa_unet_torch.ops.pooled_attention import pooled_attention_plain

    q, k, v, heads = _stage_inputs(stage, 2, dtype, card)
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        reset_launches()
        got = pooled_attention(q, k, v, heads)
        torch.cuda.synchronize()
        counts = launches()
        want = pooled_attention_plain(q, k, v, heads)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert counts["pooled_attention"] == 1 and counts["pooled_attention.more_queries"] == int(stage < 4)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 2e-5) * want.float().abs().max().item(), err


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", ["stage3", "keys64"])
def test_a_query_row_is_the_same_bits_in_any_call(card, case, dtype):
    """Rows of a call that takes part of the queries equal the same rows of the call that takes them all:
    at stage 3 (4096 queries, 1024 keys, 5 heads) and at 64 keys, where 64 queries take the turns of the
    two-warpgroup path and 256 the free-running one."""
    if case == "stage3":
        q, k, v, heads = _stage_inputs(3, 2, dtype, card, seed=7)
        parts = [(0, 64), (1000, 1300), (4000, 4096)]
    else:
        g = torch.Generator(device=card).manual_seed(8)
        q = torch.randn(3, 256, 2 * 64, generator=g, device=card).to(dtype) * 0.125
        kv = torch.randn(3, 64, 4 * 64, generator=g, device=card).to(dtype)
        k, v, heads = kv[..., :128], kv[..., 128:], 2
        parts = [(0, 64), (64, 128), (200, 256)]
    whole = pooled_attention(q, k, v, heads)
    for lo, hi in parts:
        assert torch.equal(pooled_attention(q[:, lo:hi].contiguous(), k, v, heads), whole[:, lo:hi]), (lo, hi)


@pytest.mark.card
def test_model_on_the_card(card):
    """SegFormer-B5 at published widths on two 256x256 tiles: 52 attention launches a forward (49 with
    more queries than keys: stage 4 has 8x8 of each), and in f32 the module within 1e-3 of the
    reference's logit spread (both without TF32)."""
    from portbench.reference.plain import exact_f32

    cfg = {"model": {"name": "SegFormer"}}
    sd = seeded_state(reference.state_spec(cfg), 11, card)
    model = create_model(cfg, device=card).eval()
    model.load_state_dict(sd, strict=False)
    x = torch.randn(2, 3, 256, 256, device=card)
    with torch.no_grad(), exact_f32():
        reset_launches()
        got = model(x.contiguous(memory_format=torch.channels_last))
        torch.cuda.synchronize()
        counts = launches()
        want = reference.Model(cfg, sd)(x)
    assert counts["pooled_attention"] == 52 and counts["pooled_attention.more_queries"] == 49
    assert ((got - want).abs().max() / want.std()).item() < 1e-3
