"""The port's transformer zoo (ViT-seg, TransUNet) against the goldens and the JAX models.

* tests/goldens/vit_seg_small.npz and transunet_small.npz through the port,
  weights loaded via from_jax_variables with strict=True, at the gate of
  tests/test_goldens.py: atol 5e-4, rtol 1e-3.
* The port against the JAX modules with ``use_pallas=True`` (the Pallas MHA
  kernels in interpret mode) and the same seeded weights, f32: atol 1e-4,
  rtol 1e-3 (sums in another order through the layers).
* One ViT encoder layer at full width (E=768, 12 heads, N=196).
* from_jax_variables of JAX-initialised variables, the Predictor on the CPU,
  and the factory's defaults for both configs in configs/.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import (TRANSUNET_SMALL, TRANSUNET_SMALL_IMG, VIT_SMALL, golden, images, jax_model_and_variables,
                         jax_transunet, port_model, port_transunet, to_nchw, to_nhwc, variables_from_port)
from dfc_sa_unet_tpu.config import load_config as jax_load_config
from dfc_sa_unet_tpu.infer.predictor import Predictor as JaxPredictor
from dfc_sa_unet_tpu.models.factory import create_model as jax_create_model
from dfc_sa_unet_tpu.models.vit_seg import TorchEncoderLayer as JaxEncoderLayer
from dfc_sa_unet_torch.config import load_config
from dfc_sa_unet_torch.infer.predictor import Predictor
from dfc_sa_unet_torch.inference import build_predictor
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.models.transunet import TransUNet
from dfc_sa_unet_torch.models.vit_seg import TorchEncoderLayer
from dfc_sa_unet_torch.ops import mha
from dfc_sa_unet_torch.utils.weights import calibrate_batch_stats_, from_jax_variables, init_random_

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_TOL = dict(atol=5e-4, rtol=1e-3)
JAX_TOL = dict(atol=1e-4, rtol=1e-3)
VIT_HW = (VIT_SMALL["img_dim"],) * 2
TU_HW = (TRANSUNET_SMALL_IMG,) * 2


def _port(family, seed=0):
    return port_model(VIT_SMALL, seed=seed) if family == "vit" else port_transunet(seed=seed)


def _jax(family, model, use_pallas, dtype=None):
    if family == "vit":
        return jax_model_and_variables(VIT_SMALL, model, VIT_HW, use_pallas=use_pallas, dtype=dtype)
    jmodel = jax_transunet(use_pallas=use_pallas, dtype=dtype)
    return jmodel, variables_from_port(jmodel, model, TU_HW)


@pytest.mark.parametrize("name", ["vit_seg_small", "transunet_small"])
def test_golden(name):
    variables, x, want = golden(name)
    if name == "vit_seg_small":
        model = create_model({"model": VIT_SMALL}, device="cpu")
    else:
        model = TransUNet(TRANSUNET_SMALL, img_size=TRANSUNET_SMALL_IMG, num_classes=1)
    model.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **GOLDEN_TOL)


@pytest.mark.parametrize("family", ["vit", "transunet"])
def test_model_matches_jax_with_pallas_mha(family):
    model = _port(family, seed=3)
    jmodel, variables = _jax(family, model, use_pallas=True)
    hw = VIT_HW if family == "vit" else TU_HW
    x = images(4, (2, *hw, 3))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = to_nhwc(model(to_nchw(x)))
    assert got.shape == want.shape == (2, *hw, 1)
    assert want.std() > 1e-2  # the seeded model is not a constant
    np.testing.assert_allclose(got, want, **JAX_TOL)


@pytest.mark.parametrize("family", ["vit", "transunet"])
def test_bf16_model_tracks_jax_bf16(family):
    """bf16 compute on both sides rounds at the same places; what differs is
    the order of f32 sums inside products, a few bf16 ulps by the logits:
    max |dlogit| within 0.15 of the logit spread, mean within 0.02."""
    model = _port(family, seed=5)
    jmodel, variables = _jax(family, model, use_pallas=True, dtype=jnp.bfloat16)
    hw = VIT_HW if family == "vit" else TU_HW
    x = images(6, (2, *hw, 3))
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False).astype(jnp.float32))
    if family == "vit":
        bf = create_model({"model": VIT_SMALL}, dtype=torch.bfloat16, device="cpu")
    else:
        bf = TransUNet(TRANSUNET_SMALL, img_size=TRANSUNET_SMALL_IMG, num_classes=1, compute_dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict(), strict=True)
    with torch.no_grad():
        out = bf.eval()(to_nchw(x))
    assert out.dtype == torch.bfloat16
    diff = np.abs(to_nhwc(out) - want) / want.std()
    assert diff.max() <= 0.15 and diff.mean() <= 0.02, (diff.max(), diff.mean())


def test_vit_encoder_layer_at_full_width():
    """E=768, 12 heads, N=196, MLP 3072: the shape the kernel sees on the card."""
    layer = init_random_(TorchEncoderLayer(768, 12, 3072, dropout=0.1), torch.Generator().manual_seed(1)).eval()
    jlayer = JaxEncoderLayer(12, 3072, dropout=0.1, use_pallas=True)
    x = images(2, (1, 196, 768))
    holder = torch.nn.ModuleDict({"m": layer})
    template = jax.eval_shape(lambda: jlayer.init(jax.random.key(0), jnp.asarray(x), False))
    from dfc_sa_unet_tpu.utils.torch_convert import torch_state_dict_to_variables

    variables = torch_state_dict_to_variables(holder.state_dict(), {"params": {"m": template["params"]}})
    want = np.asarray(jlayer.apply({"params": variables["params"]["m"]}, jnp.asarray(x), False))
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, **JAX_TOL)


@pytest.mark.parametrize("family", ["vit", "transunet"])
def test_from_jax_variables_loads_strict_and_gives_the_jax_output(family):
    hw = VIT_HW if family == "vit" else TU_HW
    x = images(7, (1, *hw, 3))
    if family == "vit":
        jmodel = jax_create_model({"model": VIT_SMALL}, use_pallas=True)
        model = create_model({"model": VIT_SMALL}, device="cpu")
    else:
        jmodel = jax_transunet(use_pallas=True)
        model = TransUNet(TRANSUNET_SMALL, img_size=TRANSUNET_SMALL_IMG, num_classes=1)
    variables = jmodel.init(jax.random.key(11), jnp.asarray(x), train=False)
    # JAX starts BatchNorm statistics at (0, 1) and TransUNet's position embeddings at 0: jitter
    # every leaf a little so that each one counts in the comparison
    rng = np.random.default_rng(12)
    variables = jax.tree.map(lambda a: np.asarray(a) + 0.05 * np.abs(rng.standard_normal(a.shape)).astype(np.float32),
                             variables)
    sd = from_jax_variables(variables)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = to_nhwc(model.eval()(to_nchw(x)))
    np.testing.assert_allclose(got, want, **JAX_TOL)


def test_state_dict_keys_are_the_reference_names():
    vit = set(create_model({"model": VIT_SMALL}, device="cpu").state_dict())
    assert {"pos_embed", "patch_embed.proj.weight", "transformer_encoder.layers.0.self_attn.in_proj_weight",
            "transformer_encoder.layers.0.self_attn.out_proj.bias", "transformer_encoder.layers.0.norm2.weight",
            "segmentation_head.0.weight", "segmentation_head.1.running_var", "segmentation_head.9.bias"} <= vit
    tu = set(TransUNet(TRANSUNET_SMALL, img_size=TRANSUNET_SMALL_IMG, num_classes=1).state_dict())
    assert {"transformer.embeddings.hybrid_model.root.conv.weight",
            "transformer.embeddings.hybrid_model.body.block2.unit1.gn_proj.weight",
            "transformer.embeddings.position_embeddings", "transformer.embeddings.patch_embeddings.bias",
            "transformer.encoder.layer.0.attn.query.weight", "transformer.encoder.layer.0.ffn.fc2.bias",
            "transformer.encoder.encoder_norm.weight", "decoder.conv_more.0.weight",
            "decoder.blocks.3.conv2.1.running_mean", "segmentation_head.0.bias"} <= tu


@pytest.mark.parametrize("family", ["vit", "transunet"])
def test_predictor_matches_jax_predictor(family):
    model = _port(family, seed=8)
    hw = VIT_HW if family == "vit" else TU_HW
    jmodel, variables = _jax(family, model, use_pallas=True)
    side = hw[0]
    rng = np.random.default_rng(9)
    batch = rng.integers(0, 256, (3, side, side, 3), dtype=np.uint8)
    port, jax_pred = Predictor(model, device="cpu"), JaxPredictor(jmodel, variables)
    got = port.predict_probs(batch)
    assert got.shape == (3, side, side)
    np.testing.assert_allclose(got, jax_pred.predict_probs(batch), atol=1e-5)
    img = rng.integers(0, 256, (side + 20, 2 * side - 7, 3), dtype=np.uint8)
    np.testing.assert_allclose(port.predict_sliding(img, side, side // 4, 4, tta=True),
                               jax_pred.predict_sliding(img, side, side // 4, 4, tta=True), atol=1e-5)
    stream = dict(port.predict_sliding_stream(enumerate([img, img[:side]]), side, side // 4, 4))
    np.testing.assert_allclose(stream[0], port.predict_sliding(img, side, side // 4, 4), atol=1e-6)
    with pytest.raises(ValueError, match=f"tile_size={side}"):
        port.predict_sliding(img, side + 16, 4, 4)
    with pytest.raises(ValueError, match=f"tile_size={side}"):
        next(port.predict_sliding_stream(enumerate([img]), side - 8, 4, 4))


def test_vit_refuses_another_input_size():
    model = _port("vit")
    with pytest.raises(ValueError, match="doesn't match"):
        model(torch.zeros(1, 3, 48, 48))
    with pytest.raises(ValueError, match="position"):
        _port("transunet")(torch.zeros(1, 3, 96, 96))


def test_one_channel_input_is_repeated_for_transunet():
    model = _port("transunet", seed=2)
    x = torch.from_numpy(images(3, (1, 1, *TU_HW)))
    with torch.no_grad():
        assert torch.equal(model(x), model(x.repeat(1, 3, 1, 1)))


def test_attention_goes_through_the_mha_wrappers(monkeypatch):
    """Each encoder layer calls its wrapper once: ViT-seg the packed one, TransUNet the separate one."""
    import dfc_sa_unet_torch.models.transunet as tu_mod
    import dfc_sa_unet_torch.models.vit_seg as vit_mod

    calls = {"fused_mha": 0, "fused_mha_sep": 0}

    def counted(name, fn):
        def wrapper(*args):
            calls[name] += 1
            return fn(*args)
        return wrapper

    monkeypatch.setattr(vit_mod, "fused_mha", counted("fused_mha", mha.fused_mha))
    monkeypatch.setattr(tu_mod, "fused_mha_sep", counted("fused_mha_sep", mha.fused_mha_sep))
    vit = port_model({**VIT_SMALL, "num_layers": 3})
    with torch.no_grad():
        vit(torch.zeros(1, 3, *VIT_HW))
    assert calls == {"fused_mha": 3, "fused_mha_sep": 0}
    tu = port_transunet({**TRANSUNET_SMALL, "num_layers": 2})
    with torch.no_grad():
        tu(torch.zeros(1, 3, *TU_HW))
    assert calls == {"fused_mha": 3, "fused_mha_sep": 2}


def test_training_mode_applies_dropout_but_refuses_attention_dropout(monkeypatch):
    """The name dates from when attention-weight dropout raised in training: now the fused
    core is refused there and the plain path with dropout on the weights runs, as in JAX."""
    import dfc_sa_unet_torch.models.vit_seg as vit_mod
    from dfc_sa_unet_torch.ops.dropout import set_dropout_generator

    vit = _port("vit")  # dropout 0.0 in the golden's config: training equals eval
    x = torch.from_numpy(images(1, (1, 3, *VIT_HW)))
    tu = port_transunet({**TRANSUNET_SMALL, "dropout_rate": 0.5})
    tu.train()
    torch.manual_seed(0)
    a = tu(x.repeat(1, 1, 2, 2))
    b = tu(x.repeat(1, 1, 2, 2))
    assert not torch.equal(a, b)  # the MLP and embedding dropout drew different masks
    wet = port_model({**VIT_SMALL, "dropout": 0.1}).train()

    def refused(*args):
        raise AssertionError("the fused core has no dropout on the attention weights")

    monkeypatch.setattr(vit_mod, "fused_mha", refused)
    outs = []
    for seed in (3, 3, 4):
        set_dropout_generator(wet, torch.Generator().manual_seed(seed))
        outs.append(wet(x))
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0], outs[2])
    monkeypatch.undo()
    assert vit.train()(x).shape == (1, 1, *VIT_HW)


def test_calibration_gives_seeded_models_a_logit_spread():
    for family in ("vit", "transunet"):
        model = _port(family, seed=4)
        hw = VIT_HW if family == "vit" else TU_HW
        x = to_nchw(images(5, (4, *hw, 3)))
        calibrate_batch_stats_(model, x)
        assert not model.training
        with torch.no_grad():
            assert model(x).std() > 0.1


@pytest.mark.parametrize("cfg_file", ["config_vit_seg.yaml", "config_transunet.yaml"])
def test_factory_defaults_equal_the_jax_factory(cfg_file):
    """Built on the meta device: the full-width models allocate nothing."""
    path = os.path.join(ROOT, "configs", cfg_file)
    cfg = load_config(path)
    assert cfg == jax_load_config(path)
    jmodel = jax_create_model(cfg)
    with torch.device("meta"):
        model = create_model(cfg, device="meta")
    if cfg["model"]["name"] == "VisionTransformerSegmentation":
        layer = model.transformer_encoder.layers[0]
        assert (model.img_dim, model.patch_dim, model.dropout) == (jmodel.img_dim, jmodel.patch_dim, jmodel.dropout)
        assert len(model.transformer_encoder.layers) == jmodel.num_layers == 12
        assert layer.self_attn.num_heads == jmodel.num_heads and layer.linear1.out_features == jmodel.mlp_dim
        assert model.pos_embed.shape == (1, 196, jmodel.embed_dim)
        assert sum(isinstance(m, torch.nn.ConvTranspose2d) for m in model.segmentation_head) == jmodel.upsample_layers
        assert model.segmentation_head[-1].out_channels == jmodel.num_classes == 1
    else:
        def plain(cfg_dict):
            return {k: tuple(v) if isinstance(v, (list, tuple)) else v for k, v in cfg_dict.items()}

        assert plain(model.config) == plain(jmodel.config)
        assert (model.img_dim, model.num_classes) == (jmodel.img_size, jmodel.num_classes)
        assert [len(b) for b in (model.transformer.embeddings.hybrid_model.body.block1,
                                 model.transformer.embeddings.hybrid_model.body.block2,
                                 model.transformer.embeddings.hybrid_model.body.block3)] == [3, 4, 9]
        assert model.transformer.embeddings.position_embeddings.shape == (1, 196, 768)
    n_params = sum(p.numel() for p in model.parameters())
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), jnp.zeros((1, 224, 224, 3)), train=False))
    assert n_params == sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))


def test_build_predictor_serves_the_transformers_and_keeps_engine_for_dfc():
    vit = _port("vit")
    pred = build_predictor({"model": VIT_SMALL}, vit.state_dict(), device="cpu")
    batch = np.zeros((1, *VIT_HW, 3), np.uint8)
    np.testing.assert_allclose(pred.predict_probs(batch), Predictor(vit, device="cpu").predict_probs(batch), atol=1e-6)
    with pytest.raises(ValueError, match="--engine"):
        build_predictor({"model": VIT_SMALL}, vit.state_dict(), engine=True, device="cpu")
