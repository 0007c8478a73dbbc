"""SAM ViT-B (models/sam.py) against its plain float32 reference (portbench/reference/sam_vit_b_1024.py),
and the pooled-attention wrapper's decomposed relative-position bias that it brings.

On the CPU, at a tiny width (width 64, 4 blocks with global attention at 1 and 3, heads of 32, 8x8 tokens
of 128x128 inputs, a decoder of width 32) and seeded weights, in f32: the module against the reference
within 1e-5 of the logits' largest magnitude, with windows of 3 (the map padded to 9x9) and of 4 (no
padding), at the configured box and at a box of each image's own; the wrapper's plain bias against the
source's ``add_decomposed_rel_pos`` written out; the published state-dict keys and shapes, loaded strict;
the factory's name and widths; the Predictor; the refusals.  Marked ``card`` (skipped without an NVIDIA
card): the kernel with tables at SAM's global (4096 queries and keys, 12 heads, B=2) and windowed (196, B=2
x 25 windows; also at heads of 32) launch shapes against the plain version, an f32 call with tables
refused, and the whole model's 12 launches with tables a forward.  On the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_sam.py -m card
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dfc_sa_unet_torch.infer.predictor import Predictor  # noqa: E402
from dfc_sa_unet_torch.models.factory import create_model  # noqa: E402
from dfc_sa_unet_torch.models.sam import SAM, VIT_B, rel_pos_rows  # noqa: E402
from dfc_sa_unet_torch.ops import _build, launches, reset_launches  # noqa: E402
from dfc_sa_unet_torch.ops import pooled_attention as pa  # noqa: E402
from portbench.reference import sam_vit_b_1024 as reference  # noqa: E402
from portbench.reference.plain import normalize  # noqa: E402
from portbench.weights import seeded_state  # noqa: E402

torch.set_num_threads(2)
TINY = {"name": "SAM", "img_size": 128, "patch_size": 16, "embed_dim": 64, "depth": 4, "num_heads": 2,
        "global_attn_indexes": [1, 3], "window_size": 3, "out_chans": 32, "decoder_heads": 8, "decoder_mlp_dim": 64,
        "iou_head_hidden_dim": 32, "box": [10, 20, 100, 90]}


def _tiny(seed=5, window=3, box=None, dtype=None):
    """(port module in eval mode, config, the reference's seeded state dict) at the tiny width."""
    cfg = {"model": {**TINY, "window_size": window, **({"box": box} if box is not None else {})}}
    sd = seeded_state(reference.state_spec(cfg), seed, "cpu")
    model = create_model(cfg, dtype=dtype, device="cpu").eval()
    model.load_state_dict(sd, strict=True)
    return model, cfg, sd


def _images(n=2, seed=3):
    return torch.randn(n, 3, 128, 128, generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("window", [3, 4], ids=["padded_windows", "whole_windows"])
def test_module_matches_the_reference(window):
    """Windows of 3 on the 8x8 map pad it to 9x9 (the padded tokens attend and are attended, unmasked); windows
    of 4 cut it whole.  The configured box."""
    model, cfg, sd = _tiny(window=window)
    x = _images()
    with torch.no_grad():
        got = model(x.contiguous(memory_format=torch.channels_last))
        want = reference.Model(cfg, sd)(x)
    assert got.shape == want.shape == (2, 1, 128, 128)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


def test_a_box_for_each_image():
    """forward(x, boxes): each image's logits those of the reference configured with that image's box."""
    boxes = [[0, 0, 127, 127], [30, 5, 70, 120], [64.5, 64.5, 100, 110]]
    model, _, sd = _tiny(window=3)
    x = _images(3, seed=9)
    with torch.no_grad():
        got = model(x.contiguous(memory_format=torch.channels_last), torch.tensor(boxes))
        for i, box in enumerate(boxes):
            want = reference.Model({"model": {**TINY, "box": box}}, sd)(x[i:i + 1])
            assert (got[i:i + 1] - want).abs().max().item() <= 1e-5 * want.abs().max().item(), i
        assert not torch.allclose(got[0], model(x[:1].contiguous(memory_format=torch.channels_last),
                                                torch.tensor(boxes[1:2]))[0])


def test_module_in_bf16_stays_within_rounding():
    """bf16 compute, f32 parameters: the logits within bf16 roundings of the reference's."""
    model, cfg, sd = _tiny(window=3, dtype=torch.bfloat16)
    x = _images()
    with torch.no_grad():
        got = model(x.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)).float()
        want = reference.Model(cfg, sd)(x)
    assert got.dtype == torch.float32
    assert (got - want).abs().mean().item() <= 0.05 * want.std().item()


def _add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    """image_encoder.py::add_decomposed_rel_pos, as the source writes it (equal sides, no resize)."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = rel_pos_h[torch.arange(q_h)[:, None] - torch.arange(k_h)[None, :] + (k_h - 1)]
    rw = rel_pos_w[torch.arange(q_w)[:, None] - torch.arange(k_w)[None, :] + (k_w - 1)]
    b, _, dim = q.shape
    r_q = q.reshape(b, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    return (attn.view(b, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]).view(
        b, q_h * q_w, k_h * k_w)


@pytest.mark.parametrize("side,heads", [(5, 2), (7, 3)], ids=["5x5_2heads", "7x7_3heads"])
def test_plain_bias_is_the_sources_add_decomposed_rel_pos(side, heads):
    """pooled_attention_plain with the tables computed as models/sam.py computes them (q scaled, R times
    sqrt(hd)) against the source's attention: (q * scale) @ k^T, add_decomposed_rel_pos with q unscaled,
    softmax, @ v; f32, heads side by side in the rows."""
    g = torch.Generator().manual_seed(side * heads)
    b, hd, n = 2, 16, side * side
    q, k, v = (torch.randn(b, n, heads * hd, generator=g) for _ in range(3))
    rph, rpw = (torch.randn(2 * side - 1, hd, generator=g) * 0.2 for _ in range(2))
    scale = hd ** -0.5
    qs = q * scale
    q5 = qs.unflatten(-1, (heads, hd)).unflatten(1, (side, side))
    rel_h = torch.einsum("bhwnc,hkc->bhwnk", q5, rel_pos_rows(side, rph / scale)).reshape(b, n, heads, side)
    rel_w = torch.einsum("bhwnc,wkc->bhwnk", q5, rel_pos_rows(side, rpw / scale)).reshape(b, n, heads, side)
    got = pa.pooled_attention(qs, k, v, heads, rel_h, rel_w)

    def split(t):
        return t.unflatten(-1, (heads, hd)).transpose(1, 2).flatten(0, 1)

    qh, kh, vh = split(q), split(k), split(v)
    attn = _add_decomposed_rel_pos((qh * scale) @ kh.transpose(-2, -1), qh, rph, rpw, (side, side), (side, side))
    want = (attn.softmax(dim=-1) @ vh).unflatten(0, (b, heads)).transpose(1, 2).flatten(-2)
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    assert not torch.allclose(pa.pooled_attention(qs, k, v, heads), want, atol=1e-3)


def test_tables_order_and_gradients_on_the_plain_path():
    """The bias is added to the f32 energies rel_h first, then rel_w (the kernel's order), and autograd
    reaches the tables through the kernel's Function as through the plain version."""
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, 6, 8, generator=g, requires_grad=True) for _ in range(3))
    rel_h = torch.randn(1, 6, 1, 2, generator=g, requires_grad=True)
    rel_w = torch.randn(1, 6, 1, 3, generator=g, requires_grad=True)
    e = (q @ k.transpose(1, 2)).view(1, 6, 2, 3)
    want = ((e + rel_h[:, :, 0, :, None]) + rel_w[:, :, 0, None, :]).view(1, 6, 6).softmax(-1) @ v
    got = pa.pooled_attention_plain(q, k, v, 1, rel_h, rel_w)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    w = torch.randn(1, 6, 8, generator=g)
    grads = torch.autograd.grad((got * w).sum(), (q, k, v, rel_h, rel_w))
    plain = pa.tensors_first(pa.pooled_attention_plain, 1)
    through = _build.PlainBackward.apply(plain, plain, (), q, k, v, rel_h, rel_w)
    for a, b in zip(torch.autograd.grad((through * w).sum(), (q, k, v, rel_h, rel_w)), grads):
        torch.testing.assert_close(a, b)


def test_wrapper_refuses_tables_that_do_not_fit():
    q, k, v = torch.zeros(2, 12, 16), torch.zeros(2, 12, 16), torch.zeros(2, 12, 16)
    with pytest.raises(ValueError, match="together"):
        pa.pooled_attention(q, k, v, 2, torch.zeros(2, 12, 2, 3), None)
    with pytest.raises(ValueError, match="kh x kw"):
        pa.pooled_attention(q, k, v, 2, torch.zeros(2, 12, 2, 3), torch.zeros(2, 12, 2, 5))
    with pytest.raises(ValueError, match="kh x kw"):
        pa.pooled_attention(q, k, v, 2, torch.zeros(2, 12, 1, 3), torch.zeros(2, 12, 1, 4))


def test_published_keys_and_shapes_load_strict():
    """Every key of segment_anything's SAM ViT-B state dict at its shape (written out below for a sample
    of each module, and in full through the reference's independent spec), loaded strict; the served
    forward never reads the mask prompt's path or the IoU head."""
    model = create_model({"model": {"name": "SAM"}}, device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    spec = reference.state_spec({"model": {}})
    assert got == {k: tuple(s) for k, (s, _) in spec.items()}
    assert len(got) == 314 and sum(int(np.prod(s)) for s in got.values()) == 93_735_472 + 256
    sample = {"image_encoder.pos_embed": (1, 64, 64, 768), "image_encoder.patch_embed.proj.weight": (768, 3, 16, 16),
              "image_encoder.blocks.0.attn.qkv.weight": (2304, 768), "image_encoder.blocks.0.attn.rel_pos_h": (27, 64),
              "image_encoder.blocks.2.attn.rel_pos_w": (127, 64),
              "image_encoder.blocks.11.mlp.lin1.weight": (3072, 768),
              "image_encoder.neck.0.weight": (256, 768, 1, 1), "image_encoder.neck.3.bias": (256,),
              "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix": (2, 128),
              "prompt_encoder.point_embeddings.3.weight": (1, 256), "prompt_encoder.not_a_point_embed.weight": (1, 256),
              "prompt_encoder.mask_downscaling.6.weight": (256, 16, 1, 1),
              "prompt_encoder.no_mask_embed.weight": (1, 256),
              "mask_decoder.transformer.layers.1.cross_attn_image_to_token.v_proj.weight": (128, 256),
              "mask_decoder.transformer.final_attn_token_to_image.out_proj.weight": (256, 128),
              "mask_decoder.transformer.norm_final_attn.weight": (256,), "mask_decoder.iou_token.weight": (1, 256),
              "mask_decoder.mask_tokens.weight": (4, 256), "mask_decoder.output_upscaling.0.weight": (256, 64, 2, 2),
              "mask_decoder.output_upscaling.3.weight": (64, 32, 2, 2),
              "mask_decoder.output_hypernetworks_mlps.3.layers.2.weight": (32, 256),
              "mask_decoder.iou_prediction_head.layers.2.weight": (4, 256)}
    assert {k: got[k] for k in sample} == sample
    assert not any("scale" in k or k.endswith(".box") for k in got)  # the port's own buffers stay out
    tiny, cfg, sd = _tiny()
    fresh = create_model(cfg, device="cpu")
    assert fresh.load_state_dict(sd, strict=True) is not None
    with pytest.raises(RuntimeError, match="Missing key"):
        fresh.load_state_dict({k: v for k, v in sd.items() if "iou_prediction_head" not in k}, strict=True)


def test_factory_name_and_widths():
    model = create_model({"model": {"name": "SAM"}}, device="meta")
    assert isinstance(model, SAM) and model.img_dim == 1024
    enc = model.image_encoder
    assert len(enc.blocks) == 12 and [i for i, b in enumerate(enc.blocks) if b.window_size == 0] == [2, 5, 8, 11]
    assert enc.blocks[0].window_size == 14 and enc.blocks[0].attn.num_heads == 12 and enc.blocks[0].norm1.eps == 1e-6
    assert enc.blocks[0].attn.head_dim == 64 and enc.blocks[0].attn.qkv.scale.shape == (2304,)
    tiny, _, _ = _tiny()
    scale = tiny.image_encoder.blocks[0].attn.qkv.scale
    assert scale[:64].eq(32 ** -0.5).all() and scale[64:].eq(1.0).all()
    assert model.mask_decoder.transformer.layers[0].norm1.eps == 1e-5
    assert model.mask_decoder.transformer.layers[0].skip_first_layer_pe
    assert not model.mask_decoder.transformer.layers[1].skip_first_layer_pe
    assert model.box.shape == (4,) and tiny.box.tolist() == TINY["box"] and VIT_B["box"] == (0, 0, 1023, 1023)
    with pytest.raises(ValueError, match="one mask"):
        create_model({"model": {"name": "SAM", "out_channels": 2}}, device="meta")


def test_predictor_serves_it_and_refuses_other_inputs():
    """The Predictor's path (uint8 in, normalise, forward, sigmoid) against the reference's probabilities;
    sliding tiles must be the model's size; another input size raises; row sharding raises."""
    from dfc_sa_unet_torch.parallel import rows

    model, cfg, sd = _tiny()
    pred = Predictor(model, device="cpu")
    images = torch.randint(0, 256, (2, 128, 128, 3), generator=torch.Generator().manual_seed(3), dtype=torch.uint8)
    got = pred.predict_probs(images.numpy())
    with torch.no_grad():
        want = torch.sigmoid(reference.Model(cfg, sd)(normalize(images)))[:, 0]
    assert got.shape == (2, 128, 128)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="128x128"):
        pred.predict_sliding(images[0].numpy(), tile_size=64, overlap=0)
    with pytest.raises(ValueError, match="128x128"):
        model(torch.zeros(1, 3, 64, 64))
    band = rows.Band(index=0, count=2, height=128, row0=0, prev=None, next=1)
    with rows.band_context(band), pytest.raises(NotImplementedError, match="SAM"):
        model(torch.zeros(1, 3, 128, 128))


def test_inference_cli_serves_it(tmp_path, capsys):
    """``python -m dfc_sa_unet_torch.inference`` on the CPU with a SAM config (the shipped SegFormer YAML's other
    sections, the tiny widths, f32): the factory, the Predictor's sliding tiles at the model's size, the artifacts
    and metrics written."""
    import yaml

    from dfc_sa_unet_torch import inference
    from dfc_sa_unet_torch.data.synthetic import generate

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    full = yaml.safe_load(open(os.path.join(root, "dfc_sa_unet_torch", "configs", "config_segformer_b5.yaml")))
    model, cfg, _ = _tiny()
    torch.save(model.state_dict(), tmp_path / "w.pth")
    cfg_path = tmp_path / "sam.yaml"
    dataset = {**full["dataset"], "img_size": [128, 128]}
    cfg_path.write_text(yaml.safe_dump({**full, "model": cfg["model"], "dataset": dataset}))
    data = generate(str(tmp_path / "data"), n=2, size=160, seed=4)
    inference.main(inference.parse_args(["--config", str(cfg_path), "--model", str(tmp_path / "w.pth"), "--input",
                                         data, "--output", str(tmp_path / "out"), "--tile_size", "128", "--overlap",
                                         "64", "--batch_size", "4", "--no_bf16", "--device", "cpu"]))
    assert "Micro-Averaged" in capsys.readouterr().out
    assert (tmp_path / "out" / "evaluation_metrics.csv").exists()


def test_a_forward_on_the_cpu_launches_nothing():
    """On the CPU every attention runs the plain version: no launch is counted (the card's 12 with tables
    are held by the card test below and chip_smoke.py)."""
    model, _, _ = _tiny()
    reset_launches()
    with torch.no_grad():
        model(_images(1).contiguous(memory_format=torch.channels_last))
    assert not any(launches().values())


def _launches_a_forward(depth, decoder_depth):
    """(attention launches with tables, bias passes, LayerNorms) of one SAM forward on the card: the patch conv,
    qkv, proj, lin1 and lin2 a block, 14 linears a two-way layer, the final attention's 4 and mask 0's
    hypernetwork MLP's 3; 2 LayerNorms a block, the neck's 2, 4 a two-way layer, the final one and the
    upscaling's."""
    return depth, 1 + 4 * depth + 14 * decoder_depth + 4 + 3, 2 * depth + 2 + 4 * decoder_depth + 2


def test_chip_smoke_sam_counts_are_a_forwards_calls(monkeypatch):
    """chip_smoke.py's ``SAM_LAUNCHES`` are ViT-B's counts of the rule above, and the rule counts the calls of a
    forward on the CPU (the tiny model: 4 blocks, a two-way transformer of 2)."""
    import chip_smoke
    from dfc_sa_unet_torch.models import sam
    from dfc_sa_unet_torch.nn import layers

    calls = []
    for owner, name in ((layers, "bias_add"), (layers, "layer_norm"), (sam, "pooled_attention")):
        real = getattr(owner, name)
        monkeypatch.setattr(owner, name,
                            lambda *a, _real=real, _name=name, **kw: calls.append(_name) or _real(*a, **kw))
    model, _, _ = _tiny()
    with torch.no_grad():
        model(_images(1).contiguous(memory_format=torch.channels_last))
    got = tuple(calls.count(n) for n in ("pooled_attention", "bias_add", "layer_norm"))
    assert got == _launches_a_forward(4, 2) == (4, 52, 20)
    attn, bias, norms = _launches_a_forward(12, 2)
    assert chip_smoke.SAM_LAUNCHES == {"pooled_attention": attn, "pooled_attention.rel_pos": attn, "bias_add": bias,
                                       "layer_norm": norms}


# ---------------------------------------------------------------- on the card


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _launch_inputs(b, side, device, dtype=torch.bfloat16, seed=0, heads=12, hd=64):
    """q (times 1/8, as the folded scale leaves it), k and v read where they lie in one qkv output, and the two
    tables at about half the energies' spread, at SAM's launch shape of a side ``side``."""
    g = torch.Generator(device=device).manual_seed(seed)
    n, e = side * side, heads * hd
    qkv = torch.randn(b, n, 3 * e, generator=g, device=device).to(dtype)
    q = (qkv[..., :e].float() * 0.125).to(dtype)
    rel_h = (torch.randn(b, n, heads, side, generator=g, device=device) * 0.5).to(dtype)
    rel_w = (torch.randn(b, n, heads, side, generator=g, device=device) * 0.5).to(dtype)
    return q, qkv[..., e:2 * e], qkv[..., 2 * e:], heads, rel_h, rel_w


@pytest.mark.card
@pytest.mark.parametrize("b,side,hd", [(2, 64, 64), (50, 14, 64), (50, 14, 32)],
                         ids=["global_4096", "windowed_196", "windowed_196_heads_of_32"])
def test_kernel_with_tables_at_the_launch_shapes(card, b, side, hd):
    """bf16 within 2e-2 of the plain version's largest output (the pooled tests' allowance), after a launch on
    NaN tables; one launch, counted under rel_pos; the tables move the output.  Heads of 32 take the kernel's
    64-channel instantiation with q's and k's channels past 32 read as zeros."""
    q, k, v, heads, rel_h, rel_w = _launch_inputs(b, side, card, hd=hd)
    nan = float("nan")
    pa.pooled_attention(q, k, v, heads, torch.full_like(rel_h, nan), torch.full_like(rel_w, nan))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        reset_launches()
        got = pa.pooled_attention(q, k, v, heads, rel_h, rel_w)
        torch.cuda.synchronize()
        counts = launches()
        want = pa.pooled_attention_plain(q, k, v, heads, rel_h, rel_w).float()
        without = pa.pooled_attention_plain(q, k, v, heads).float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    assert counts["pooled_attention"] == 1 and counts["pooled_attention.rel_pos"] == 1
    scale = want.abs().max().item()
    err = (got.float() - want).abs().max().item()
    assert err <= 2e-2 * scale, err
    assert (without - want).abs().max().item() > 10 * err


@pytest.mark.card
def test_tables_refused_in_f32_on_the_card(card):
    q, k, v, heads, rel_h, rel_w = _launch_inputs(1, 14, card, dtype=torch.float32)
    with pytest.raises(ValueError, match="bf16"):
        pa.pooled_attention(q, k, v, heads, rel_h, rel_w)


@pytest.mark.card
def test_model_launches_twelve_with_tables(card):
    """SAM ViT-B at published widths, bf16, one 1024x1024 image: 12 pooled-attention launches a forward, each
    with tables, finite logits."""
    cfg = {"model": {"name": "SAM"}}
    sd = seeded_state(reference.state_spec(cfg), 11, card)
    model = create_model(cfg, dtype=torch.bfloat16, device=card).eval()
    model.load_state_dict(sd, strict=True)
    x = torch.randn(1, 3, 1024, 1024, device=card).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        reset_launches()
        y = model(x)
        torch.cuda.synchronize()
    counts = launches()
    assert counts["pooled_attention"] == 12 and counts["pooled_attention.rel_pos"] == 12
    assert y.shape == (1, 1, 1024, 1024) and torch.isfinite(y).all()
