"""One training step of the small ViT-seg and the small TransUNet through the
port's Trainer against the JAX Trainer with ``use_pallas=True`` (its fused
MHA kernels in interpret mode, their VJPs through the lax reference): the
slice as a whole for the transformer families.  Dropout is 0 in both
configs, since the two frameworks cannot share a dropout stream; tolerances
in ``_torch_port.assert_step_matches``.
"""

import pytest
import torch

from _torch_port import (TRANSUNET_SMALL, TRANSUNET_SMALL_IMG, VIT_SMALL, assert_step_matches, jax_model_and_variables,
                         jax_transunet, port_model, port_transunet, run_both_trainers, train_config, uint8_batches)

torch.set_num_threads(2)


def test_vit_seg_step_matches_the_jax_trainer(tmp_path):
    cfg = train_config(tmp_path, VIT_SMALL)
    model = port_model(VIT_SMALL, seed=3)
    jmodel, _ = jax_model_and_variables(VIT_SMALL, model, use_pallas=True)
    steps, init = run_both_trainers(cfg, model, jmodel, (32, 32), uint8_batches(1, 2, 4, (32, 32)))
    for step in steps:
        assert_step_matches(*step, init)


def test_transunet_step_matches_the_jax_trainer(tmp_path):
    """The batch seed is one where no max-pool window of the backbone's root holds two values
    within an f32 rounding of each other: where one does (batch seed 2), the two frameworks
    route that window's gradient to different pixels and one channel's update of
    root.conv.weight moves by 3.6%, every other tensor agreeing to an ulp."""
    hw = (TRANSUNET_SMALL_IMG, TRANSUNET_SMALL_IMG)
    cfg = train_config(tmp_path, {"name": "TransUNet"})
    model = port_transunet(seed=4)
    steps, init = run_both_trainers(cfg, model, jax_transunet(use_pallas=True), hw, uint8_batches(3, 1, 2, hw))
    assert_step_matches(*steps[0], init)


@pytest.mark.parametrize("family", ["vit", "transunet"])
def test_remat_gives_the_same_loss_and_gradients(family):
    """Every encoder layer, ResNet unit and decoder block recomputed, with dropout on:
    the recomputation replays the trainer's generator, so nothing changes (1e-6)."""
    from dfc_sa_unet_torch.models.transunet import TransUNet
    from dfc_sa_unet_torch.models.vit_seg import VisionTransformerForSegmentation
    from dfc_sa_unet_torch.ops.dropout import set_dropout_generator
    from dfc_sa_unet_torch.utils.weights import init_random_

    grads = {}
    for remat in (False, True):
        if family == "vit":
            model = VisionTransformerForSegmentation(img_dim=32, patch_dim=8, embed_dim=32, num_layers=2, num_heads=2,
                                                     mlp_dim=64, dropout=0.2, upsample_layers=3, remat=remat)
            x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0))
        else:
            model = TransUNet({**TRANSUNET_SMALL, "dropout_rate": 0.2, "attention_dropout_rate": 0.1},
                              img_size=TRANSUNET_SMALL_IMG, num_classes=1, remat=remat)
            x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
        init_random_(model, torch.Generator().manual_seed(1)).train()
        set_dropout_generator(model, torch.Generator().manual_seed(5))
        loss = torch.sigmoid(model(x)).mean()
        loss.backward()
        grads[remat] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()},
                        {n: b.clone() for n, b in model.named_buffers()})
    assert abs(grads[True][0] - grads[False][0]) <= 1e-6
    for name, g in grads[False][1].items():
        assert torch.allclose(grads[True][1][name], g, rtol=0, atol=1e-6 * max(1.0, g.abs().max().item())), name
    for name, b in grads[False][2].items():  # BatchNorm statistics moved once, not twice
        assert torch.equal(grads[True][2][name], b), name
