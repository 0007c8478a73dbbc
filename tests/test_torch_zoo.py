"""The port's DFC zoo (the vanilla UNet and the eight ablation models) against
the torch-reference goldens and the JAX modules.

* Each of the nine goldens through the port, weights loaded strictly via
  ``from_jax_variables``: atol 5e-4, rtol 1e-3, the gate of
  tests/test_goldens.py (the goldens were captured from the reference).
* Each of the nine names against its JAX module with the port's seeded
  weights converted by the JAX package's converter, eval mode, both f32:
  atol 1e-4, rtol 1e-3 (the same f32 sums in another order through nine
  blocks).  ``use_pallas=True`` on the JAX side, so its attention runs the
  Pallas kernel in interpret mode wherever the JAX factory sends it there
  (it never does for the full-resolution model, dfc_sa_unet_tpu/models/
  ablations.py:69-73; that block is held against the kernel below).
* Each new block against its JAX block: 1e-5 of max|reference|.
* The predictor on one ablation model against the JAX predictor: 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import golden, images, jax_model_and_variables, port_model, to_nchw, to_nhwc
from dfc_sa_unet_tpu.models import blocks as jax_blocks
from dfc_sa_unet_tpu.utils.torch_convert import torch_state_dict_to_variables
from dfc_sa_unet_torch.models import blocks
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.utils.weights import from_jax_variables, init_random_

torch.set_num_threads(2)
SMALL = {"features": [8, 16, 24, 32], "pool_size": 4}
# golden file -> model config (tests/test_goldens.py:25-35)
GOLDENS = {
    "unet": {"name": "UNet", "bilinear": False},
    "baseline_small": {"name": "UNet_Baseline", **SMALL},
    "attention_only_small": {"name": "UNet_AttentionOnly", **SMALL},
    "addition_fusion_small": {"name": "UNet_AdditionFusion", **SMALL},
    "concat_fusion_small": {"name": "UNet_ConcatFusion", **SMALL},
    "full_res_attention_small": {"name": "UNet_FullResAttention", **SMALL},
    "encoder_only_small": {"name": "UNet_EncoderOnlyDFC", **SMALL},
    "decoder_only_small": {"name": "UNet_DecoderOnlyDFC", **SMALL},
    "both_standard_small": {"name": "UNet_BothStandardConv", **SMALL},
}
# image sizes of the JAX comparison: the UNet at an odd size (ceil-mode pooling keeps the last row
# and column, so every Up cuts its upsampled x1 back to the skip), one ablation at an odd size
# (bilinear shape fix after the transposed convs), the full-resolution model at 32x32 (N = 1024)
SIZES = {"UNet": (37, 45), "UNet_ConcatFusion": (48, 40), "UNet_FullResAttention": (32, 32)}


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_golden(name):
    variables, x, want = golden(name)
    model = create_model({"model": GOLDENS[name]}, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=1e-3)


@pytest.mark.parametrize("cfg", list(GOLDENS.values()), ids=lambda c: c["name"])
def test_matches_jax_module(cfg):
    hw = SIZES.get(cfg["name"], (32, 32))
    model = port_model(cfg, seed=11)
    jmodel, variables = jax_model_and_variables(cfg, model, hw, use_pallas=True)
    x = images(11, (2, *hw, 3))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = to_nhwc(model(to_nchw(x)))
    assert np.abs(want).max() > 0.05  # the comparison is not of two near-zero maps
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_unet_bilinear_matches_jax_module():
    """``bilinear: true``: align_corners=True resizes and a decoder at half the widths."""
    cfg = {"name": "UNet", "bilinear": True}
    model = port_model(cfg, seed=12)
    assert not hasattr(model.up1, "up") and model.down4.mpconv[1].conv[0].out_channels == 512
    jmodel, variables = jax_model_and_variables(cfg, model, (37, 45))
    x = images(12, (1, 37, 45, 3))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = to_nhwc(model(to_nchw(x)))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def _block_pair(kind):
    """(port block, JAX block, input channels) at 6 -> 16 channels, pool 4."""
    if kind == "local":
        return blocks.LocalOnlyBlock(6, 16), jax_blocks.LocalOnlyBlock(features=16)
    if kind == "attention":
        return (blocks.AttentionOnlyBlock(6, 16, pool_size=4),
                jax_blocks.AttentionOnlyBlock(features=16, pool_size=4, use_pallas=True))
    if kind == "addition":
        return (blocks.AdditionFusionBlock(6, 16, pool_size=4),
                jax_blocks.AdditionFusionBlock(features=16, pool_size=4, use_pallas=True))
    if kind == "concat":
        return (blocks.ConcatFusionBlock(6, 16, pool_size=4),
                jax_blocks.ConcatFusionBlock(features=16, pool_size=4, use_pallas=True))
    if kind == "identity_residual":  # equal channel counts: no residual_conv keys
        return blocks.LocalOnlyBlock(6, 6), jax_blocks.LocalOnlyBlock(features=6)
    # the full-resolution DFC block with the JAX side on its Pallas kernel (interpret mode), which
    # the JAX factory never builds: 40x40 = 1600 tokens, past the short kernel's 1024
    return (blocks.DFCBlock(6, 16, qk_div=8, full_res=True),
            jax_blocks.DFCBlock(features=16, qk_div=8, full_res=True, use_pallas=True))


@pytest.mark.parametrize("kind,hw", [("local", (13, 10)), ("attention", (13, 10)), ("addition", (13, 10)),
                                     ("concat", (13, 10)), ("identity_residual", (13, 10)),
                                     ("dfc_fullres", (40, 40))], ids=lambda v: v if isinstance(v, str) else None)
def test_block_matches_jax_block(kind, hw):
    block, jblock = _block_pair(kind)
    init_random_(block, torch.Generator().manual_seed(5)).eval()
    x = images(5, (2, *hw, 6))
    template = jax.eval_shape(lambda: jblock.init(jax.random.key(0), jnp.asarray(x[:1]), train=False))
    variables = jax.tree.map(jnp.asarray, torch_state_dict_to_variables(block.state_dict(), template))
    want = np.asarray(jblock.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = to_nhwc(block(to_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_block_state_dict_keys():
    """The reference's keys: no attention keys on a local-only block, the bias-free
    projection only where the channel counts differ, qk at C//8 whatever the flagship's
    ``ablation_on_qk_channels`` says."""
    local = set(blocks.LocalOnlyBlock(3, 8).state_dict())
    assert local == {"res_scale", "residual_conv.weight", "conv_branch.0.weight", "conv_branch.0.bias",
                     "conv_branch.1.weight", "conv_branch.1.bias", "conv_branch.1.running_mean",
                     "conv_branch.1.running_var", "conv_branch.1.num_batches_tracked"}
    assert "residual_conv.weight" not in blocks.LocalOnlyBlock(8, 8).state_dict()
    attn = blocks.AttentionOnlyBlock(3, 16)  # down1 reads the 3-channel image
    assert attn.residual_conv.weight.shape == (16, 3, 1, 1) and attn.residual_conv.bias is None
    assert attn.attn_branch[3].query_conv.weight.shape == (2, 16, 1, 1)
    assert not any(k.startswith("conv_branch") for k in attn.state_dict())
    cfg = {"name": "UNet_EncoderOnlyDFC", **SMALL, "ablation_on_qk_channels": 2}
    assert create_model({"model": cfg}, device="cpu").down2.attn_branch[3].query_conv.out_channels == 2
    with pytest.raises(RuntimeError, match="attn_branch"):  # strict loading says what is missing
        blocks.AttentionOnlyBlock(3, 8).load_state_dict(blocks.LocalOnlyBlock(3, 8).state_dict(), strict=True)


def test_factory_defaults_and_unknown_name():
    """The JAX factory's defaults (factory.py:31-45,113-121): 3 -> 1 channels, features
    64/128/256/512, pool 8, transposed-conv UNet; remat does not reach these models."""
    model = create_model({"model": {"name": "UNet_AdditionFusion"}}, device="cpu", remat="l12")
    assert model.down1.conv_branch[0].weight.shape == (64, 3, 3, 3)
    assert model.bottleneck.conv_branch[0].out_channels == 1024 and model.final_conv.out_channels == 1
    assert model.down1.attn_branch[3].pool_size == 8 and not hasattr(model, "remat")
    full = create_model({"model": {"name": "UNet_FullResAttention", "in_channels": 1, "out_channels": 2}},
                        device="cpu")
    assert full.up_conv1.attn_branch[3].pool_size is None and full.final_conv.out_channels == 2
    unet = create_model({"name": "UNet"}, dtype=torch.bfloat16, device="cpu", remat=True)
    assert isinstance(unet.up1.up, torch.nn.ConvTranspose2d) and unet.outc.conv.weight.shape == (1, 64, 1, 1)
    assert unet.inc.conv[0].compute_dtype == torch.bfloat16 and unet.outc.conv.weight.dtype == torch.float32
    for name in ("UNet_Other", "unet", ""):
        with pytest.raises(ValueError, match="unsupported model name"):
            create_model({"model": {"name": name}}, device="cpu")


def test_predictor_matches_jax_predictor():
    from dfc_sa_unet_tpu.infer.predictor import Predictor as JaxPredictor
    from dfc_sa_unet_torch.infer.predictor import Predictor

    cfg = GOLDENS["attention_only_small"]
    model = port_model(cfg, seed=13)
    jmodel, variables = jax_model_and_variables(cfg, model, (48, 48))
    img = np.random.default_rng(13).integers(0, 256, (100, 90, 3), dtype=np.uint8)
    got = Predictor(model, device="cpu").predict_sliding(img, 48, 12, 8, tta=True)
    want = JaxPredictor(jmodel, variables).predict_sliding(img, 48, 12, 8, tta=True)
    assert got.shape == (100, 90)
    np.testing.assert_allclose(got, want, atol=1e-5)
