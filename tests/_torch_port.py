"""Shared helpers of the tests that hold dfc_sa_unet_torch against dfc_sa_unet_tpu.

Weights are made once, by the port from a seeded torch.Generator (with
jittered BatchNorm statistics and a non-zero attention gamma, so BN
folding and the attention branch both count), and handed to JAX through
the JAX package's own converter, with a template from ``jax.eval_shape``
so no JAX init runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dfc_sa_unet_tpu.models.factory import create_model as jax_create_model
from dfc_sa_unet_tpu.utils.torch_convert import torch_state_dict_to_variables
from dfc_sa_unet_torch.models.factory import create_model
from dfc_sa_unet_torch.utils.weights import init_random_

SMALL = {"name": "DFC-SA-Res-Block", "features": [8, 16, 24, 32], "pool_size": 4}
# the configurations of tests/goldens/vit_seg_small.npz and transunet_small.npz
# (tests/test_goldens.py:36-55); the TransUNet one is built as a module, not by the factory
VIT_SMALL = {"name": "VisionTransformerSegmentation", "img_dim": 32, "patch_dim": 8, "in_channels": 3,
             "out_channels": 1, "embed_dim": 32, "num_layers": 1, "num_heads": 2, "mlp_dim": 64,
             "dropout": 0.0}
TRANSUNET_SMALL = {"patches_grid": (4, 4), "resnet_num_layers": (1, 1, 1), "resnet_width_factor": 1,
                   "hidden_size": 64, "mlp_dim": 128, "num_heads": 2, "num_layers": 1,
                   "attention_dropout_rate": 0.0, "dropout_rate": 0.0, "decoder_channels": (32, 16, 8, 8),
                   "skip_channels": [512, 256, 64, 16], "n_classes": 1, "n_skip": 3}
TRANSUNET_SMALL_IMG = 64


def port_model(model_cfg, seed=0, use_pallas=False):
    """Port module on the CPU with seeded weights, in eval mode."""
    model = create_model({"model": model_cfg}, use_pallas=use_pallas, device="cpu")
    return init_random_(model, torch.Generator().manual_seed(seed)).eval()


def jax_model_and_variables(model_cfg, model, image_hw=(32, 32), use_pallas=False, dtype=None):
    """The JAX module of ``model_cfg`` and the port model's weights as Flax variables."""
    jmodel = jax_create_model({"model": model_cfg}, use_pallas=use_pallas, dtype=dtype)
    return jmodel, variables_from_port(jmodel, model, image_hw, model_cfg.get("in_channels", 3))


def port_transunet(vit_config=TRANSUNET_SMALL, img_size=TRANSUNET_SMALL_IMG, seed=0):
    """Port TransUNet built as a module (the golden's way), seeded weights, eval mode."""
    from dfc_sa_unet_torch.models.transunet import TransUNet

    model = TransUNet(vit_config, img_size=img_size, num_classes=vit_config["n_classes"])
    return init_random_(model, torch.Generator().manual_seed(seed)).eval()


def jax_transunet(vit_config=TRANSUNET_SMALL, img_size=TRANSUNET_SMALL_IMG, use_pallas=False, dtype=None):
    from dfc_sa_unet_tpu.models.transunet import TransUNet as JaxTransUNet

    return JaxTransUNet(config=dict(vit_config), img_size=img_size, num_classes=vit_config["n_classes"],
                        use_pallas=use_pallas, dtype=dtype)


def variables_from_port(jmodel, model, image_hw, in_channels=3):
    """The port model's weights as Flax variables of ``jmodel``."""
    x = jnp.zeros((1, *image_hw, in_channels), jnp.float32)
    template = jax.eval_shape(lambda: jmodel.init(jax.random.key(0), x, train=False))
    return jax.tree.map(jnp.asarray, torch_state_dict_to_variables(model.state_dict(), template))


def golden(name):
    """(Flax-style nested variables of numpy arrays, NCHW input, NCHW output) of a golden file."""
    import os

    g = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", f"{name}.npz"))
    variables = {}
    for key in g.files:
        if key.startswith("__"):
            continue
        coll, path = key.split("::", 1)
        node = variables.setdefault(coll, {})
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.asarray(g[key], np.float32)
    return variables, g["__input__"].astype(np.float32), g["__output__"]


def images(seed, shape):
    """Normalised-scale f32 NHWC images."""
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def to_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x_nhwc).permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).float().numpy()


# ---------------------------------------------------------------- training

def train_config(tmp_path, model_cfg=None, **training):
    """A config for the small trainers of the tests: bce_dice 0.5/0.5 and the
    SGD settings of configs/config_dfc-sa-res-block.yaml."""
    log_dir = str(tmp_path / "logs")
    return {
        "training": {"num_epochs": 1, "batch_size": 4, "learning_rate": 0.01, "momentum": 0.9,
                     "weight_decay": 1e-4, "num_workers": 1, "save_checkpoint_freq": 100,
                     "loss": {"type": "bce_dice", "params": {"bce_weight": 0.5, "dice_weight": 0.5}},
                     **training},
        "model": dict(model_cfg or SMALL),
        "dataset": {"img_size": [32, 32], "augmentation": False},
        "logging": {"log_dir": log_dir, "images_dir": log_dir + "/images", "save_best_worst_samples": 0},
    }


def uint8_batches(seed, n, b, hw):
    """n batches of uint8 images [b,H,W,3] and blob-like masks [b,H,W]."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.integers(0, 256, (b, *hw, 3), dtype=np.uint8)
        mask = ((img[..., 0].astype(np.int32) + img[..., 1]) > 255).astype(np.uint8) * 255
        out.append((img, mask))
    return out


def state_dict_of_jax_state(state):
    """The JAX TrainState's weights and BatchNorm statistics under the port's names, as numpy."""
    from dfc_sa_unet_torch.utils.weights import from_jax_variables

    sd = from_jax_variables({"params": jax.tree.map(np.asarray, state.params),
                             "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    return {k: v.numpy() for k, v in sd.items()}


def run_both_trainers(cfg, model, jmodel, image_hw, batches):
    """The same uint8 batches through the port's Trainer.train_step and the JAX
    Trainer's jitted ``_step_impl``, both started from ``model``'s weights.
    Returns per step (port metrics, JAX metrics, port state dict, JAX state dict)
    and the initial state dict."""
    from dfc_sa_unet_tpu.train.trainer import Trainer as JaxTrainer
    from dfc_sa_unet_torch.train.trainer import Trainer

    variables = variables_from_port(jmodel, model, image_hw)
    jt = JaxTrainer(jmodel, None, None, cfg, seed=0, init_variables=variables)
    state = jt.init_state(None)
    trainer = Trainer(model, None, None, cfg, seed=0, device="cpu", progress=False)
    init = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}
    steps = []
    for img, mask in batches:
        state, jm = jt._train_step_jit(state, jnp.asarray(img), jnp.asarray(mask))
        tm = trainer.train_step(torch.from_numpy(img), torch.from_numpy(mask))
        steps.append((tm, {k: float(v) for k, v in jm.items()},
                      {k: v.detach().numpy().copy() for k, v in model.state_dict().items()},
                      state_dict_of_jax_state(state)))
    return steps, init


def assert_step_matches(tm, jm, port_sd, jax_sd, init, updates=True):
    """Loss, IoU, Dice 1e-5; parameter updates |d_port - d_jax| <= 1e-3 max|d_jax| + 1e-7 per
    tensor (unless ``updates`` is False); BatchNorm running statistics 1e-5."""
    assert tm["finite"] and jm["finite"]
    for k in ("loss", "iou", "dice"):
        assert abs(tm[k] - jm[k]) <= 1e-5 * max(1.0, abs(jm[k])), (k, tm[k], jm[k])
    for name, want in jax_sd.items():
        got = port_sd[name]
        if name.endswith("num_batches_tracked"):
            continue
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()), err_msg=name)
            continue
        if not updates:
            continue
        d_jax, d_port = want - init[name], got - init[name]
        tol = 1e-3 * np.abs(d_jax).max() + 1e-7
        assert np.abs(d_port - d_jax).max() <= tol, (name, np.abs(d_port - d_jax).max(), tol)


def update_disagreement(port_sd, jax_sd, init):
    """The largest, over the parameter tensors, of max|d_port - d_jax| / max|d_jax| (d: the update)."""
    worst = 0.0
    for name, want in jax_sd.items():
        if name.endswith(("num_batches_tracked", "running_mean", "running_var")):
            continue
        d_jax, d_port = want - init[name], port_sd[name] - init[name]
        worst = max(worst, float(np.abs(d_port - d_jax).max() / max(np.abs(d_jax).max(), 1e-30)))
    return worst


def train_on_synthetic(tmp_path, model, model_cfg, size, epochs, lr):
    """``model`` trained by the port's Trainer on 16 synthetic ellipse images (seed 3) with 8 held out
    (seed 4), batch 8, bce_dice, SGD: the setting of the JAX int8 tests' Dice gates.  Returns (the model
    in eval mode, the config, the training samples, the held-out samples)."""
    from dfc_sa_unet_torch.data.dataset import ArrayDataset
    from dfc_sa_unet_torch.data.loader import BatchLoader
    from dfc_sa_unet_torch.data.synthetic import samples
    from dfc_sa_unet_torch.train.trainer import Trainer

    cfg = train_config(tmp_path, model_cfg, num_epochs=epochs, batch_size=8, learning_rate=lr)
    cfg["dataset"]["img_size"] = [size, size]
    train = list(samples(n=16, size=size, seed=3))
    val = list(samples(n=8, size=size, seed=4))
    trainer = Trainer(model, BatchLoader(ArrayDataset(train), 8, shuffle=True, num_workers=1, seed=0),
                      BatchLoader(ArrayDataset(val), 8, shuffle=False, num_workers=1, seed=0), cfg, seed=0,
                      device="cpu", progress=False)
    for epoch in range(epochs):
        trainer.train_epoch(epoch)
    return trainer.model.eval(), cfg, train, val


def micro_dice(engine, items):
    """Micro-averaged Dice of ``engine``'s masks (probability > 0.5) on (name, image, mask) items."""
    from dfc_sa_unet_torch.data.normalize import normalize
    from dfc_sa_unet_torch.metrics import confusion_counts, metrics_from_counts

    xs = normalize(torch.from_numpy(np.stack([img for _, img, _ in items]))).permute(0, 3, 1, 2)
    gt = torch.from_numpy(np.stack([m for _, _, m in items]) > 127)
    with torch.no_grad():
        pred = torch.sigmoid(engine(xs))[:, 0] > 0.5
    return metrics_from_counts(**confusion_counts(pred, gt))["dice_f1"]


def normalised(items):
    from dfc_sa_unet_torch.data.normalize import normalize

    return normalize(torch.from_numpy(np.stack([img for _, img, _ in items]))).permute(0, 3, 1, 2)
