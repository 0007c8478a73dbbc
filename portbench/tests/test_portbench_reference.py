"""The plain references against the program's CPU path (the kernels' plain versions) at a tiny
width, float32: the serving forward of every path the cells serve, and the training step's loss,
gradients, update and BatchNorm statistics."""

import pytest
import torch

from portbench import compare
from portbench.reference.plain import bce_dice_loss, masks_to_target, normalize, sgd_step
from portbench.tests.tiny import tiny_cell
from portbench.traffic import ellipses
from portbench.weights import seeded_state


def _state(cell, seed=5):
    return seeded_state(cell.reference.state_spec(cell.config), seed, "cpu")


def _module(cell, sd):
    from dfc_sa_unet_torch.models.factory import create_model

    model = create_model(cell.config, device="cpu")
    missing, unexpected = model.load_state_dict(sd, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    return model


@pytest.mark.parametrize("name,path", [("dfc_serve_b128", "module"), ("dfc_serve_b128", "engine"),
                                       ("transunet_serve_b128", "module")])
def test_serving_forward_matches_the_program(name, path):
    from dfc_sa_unet_torch.infer.predictor import Predictor

    cell = tiny_cell(name)
    sd = _state(cell)
    h, w = cell.config["dataset"]["img_size"]
    images, _ = ellipses(3, h, w, 11, "cpu")
    if path == "engine":
        from dfc_sa_unet_torch.infer.engine import DFCEngine

        model = DFCEngine(cell.config, sd, dtype=torch.float32, device="cpu", tail_kernel_levels="auto",
                          conv_kernel_levels="auto")
    else:
        model = _module(cell, sd)
    got = Predictor(model, device="cpu").predict_probs(images.numpy())
    with torch.no_grad():
        want = torch.sigmoid(cell.reference.Model(cell.config, sd)(normalize(images)))[:, 0].numpy()
    assert abs(got - want).max() < 1e-4


def test_training_step_matches_the_program():
    """One step of the program's module and optimiser in float32 against the reference's: loss,
    the direction the optimiser takes, the parameters after it and BatchNorm's running statistics."""
    from dfc_sa_unet_torch.data.normalize import normalize as program_normalize
    from dfc_sa_unet_torch.losses import compute_loss
    from dfc_sa_unet_torch.train.optim import SGDWithClip

    cell = tiny_cell("dfc_train_b64")
    tr = cell.config["training"]
    sd = _state(cell)
    images, masks = ellipses(4, 32, 32, 3, "cpu")
    model = _module(cell, sd).train()
    opt = SGDWithClip(model.named_parameters(), tr["learning_rate"], tr["momentum"], tr["weight_decay"])
    probs = torch.sigmoid(model(program_normalize(images).permute(0, 3, 1, 2)))
    loss = compute_loss(probs, (masks >= 128).float().unsqueeze(1), "bce_dice", tr["loss"]["params"])
    loss.backward()
    opt.step()

    names = [n for n, _ in opt.named_params]
    params = {n: sd[n].clone().requires_grad_(True) for n in names}
    ref = cell.reference.Model(cell.config, {**sd, **params}, train=True, checkpoint=True)
    ref_loss = bce_dice_loss(torch.sigmoid(ref(normalize(images))), masks_to_target(masks))
    grads = dict(zip(names, torch.autograd.grad(ref_loss, list(params.values()))))
    direction = sgd_step(params, grads, {}, tr["learning_rate"], tr["momentum"], tr["weight_decay"])

    assert abs(loss.item() - ref_loss.item()) < 1e-5
    got = dict(model.state_dict())
    assert compare.worst_leaf(compare.leaf_gaps(opt.momentum_buffers, direction, names))[0] < 1e-2
    assert compare.worst_leaf(compare.leaf_gaps(got, params, names))[0] < 1e-5
    moved = ref.norms.moved()
    assert compare.worst_leaf(compare.leaf_gaps(got, moved, list(moved)))[0] < 1e-5


def test_fp8_is_coarser_than_float32():
    """The control's precision departs from float32 by far more than float32 rounding."""
    cell = tiny_cell("dfc_serve_b128")
    sd = _state(cell)
    images, _ = ellipses(2, 32, 32, 1, "cpu")
    with torch.no_grad():
        x = normalize(images)
        f32 = cell.reference.Model(cell.config, sd)(x)
        fp8 = cell.reference.Model(cell.config, sd, precision="fp8")(x)
        bf16 = cell.reference.Model(cell.config, sd, precision="bf16")(x)
    assert (fp8 - f32).abs().mean() > 4 * (bf16 - f32).abs().mean() > 0
